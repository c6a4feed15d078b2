"""The port's orbax artifacts and the other last-ported paths, on the CPU.

* orbax artifacts, float32 and bfloat16, of a tiny Llama, a tied OPT
  (``lm_head`` None), a qwen3_moe stack and a compressed Llama with
  heterogeneous ranks (the committed JAX-written fixture's npz twin):
  JAX-written ones load in the port, and port-written ones in the JAX
  package, bit for bit;
* the orbax compression job: the port's CLI with ``--artifact_backend
  orbax`` against the JAX package's orbax job (rank lists, perplexity
  to rtol 1e-3) and the port's own npz job (perplexity to rtol 1e-6);
* quantised storage with orbax raises ValueError, as in JAX;
* the zstd decoder against ``zstandard`` (a hypothesis property over
  levels, sizes, header flags and frames back to back), and corrupt
  input raising;
* the OCDBT store: a port-written tree of several nodes read by
  tensorstore, and tensorstore-written stores (zstd nodes, interior
  nodes, version-tree nodes, a merged per-process store) read by the
  port;
* the committed fixture ``tests/fixtures/torch_orbax_llama`` (written by
  the JAX package, zstd inside): the port loads it equal to its npz
  twin, and the JAX package still writes values equal to it;
* ``solve_layer`` and ``psd_diagnostics`` against JAX's, the solver's
  ``--debug`` log, and the memory watchdog.
"""

import json
import logging
import os
import threading

import numpy as np
import pytest

torch = pytest.importorskip("torch")
transformers = pytest.importorskip("transformers")
zstandard = pytest.importorskip("zstandard")
tensorstore = pytest.importorskip("tensorstore")
from hypothesis import HealthCheck, given, settings  # noqa: E402
from hypothesis import strategies as st  # noqa: E402

from modegpt_tpu.calib.data import load_calibration_batches  # noqa: E402
from modegpt_tpu.compress import artifact as j_artifact  # noqa: E402
from modegpt_tpu.compress.pipeline import run_compression as j_run  # noqa: E402
from modegpt_tpu.compress.pipeline import solve_layer as j_solve_layer  # noqa: E402
from modegpt_tpu.calib.engine import calibrate as j_calibrate  # noqa: E402
from modegpt_tpu.config import CompressionConfig as JConfig  # noqa: E402
from modegpt_tpu.models import params_from_hf_model as j_params_from_hf  # noqa: E402
from modegpt_tpu.ops.psd import psd_diagnostics as j_psd_diagnostics  # noqa: E402
from modegpt_tpu_torch.calib.engine import calibrate as t_calibrate  # noqa: E402
from modegpt_tpu_torch.cli import main as t_cli  # noqa: E402
from modegpt_tpu_torch.compress import artifact as t_artifact  # noqa: E402
from modegpt_tpu_torch.compress import ocdbt, zstd  # noqa: E402
from modegpt_tpu_torch.compress.batched import solve_chunk_batched as t_solve_chunk  # noqa: E402
from modegpt_tpu_torch.compress.pipeline import run_compression as t_run  # noqa: E402
from modegpt_tpu_torch.compress.pipeline import solve_layer as t_solve_layer  # noqa: E402
from modegpt_tpu_torch.config import CompressionConfig as TConfig  # noqa: E402
from modegpt_tpu_torch.models.hf import params_from_hf_model as t_params_from_hf  # noqa: E402
from modegpt_tpu_torch.ops.psd import psd_diagnostics as t_psd_diagnostics  # noqa: E402
from modegpt_tpu_torch.utils.memory import start_memory_watchdog  # noqa: E402

FIXTURE = os.path.join(os.path.dirname(os.path.abspath(__file__)), "fixtures", "torch_orbax_llama")
ARCHS = ["llama", "opt", "qwen3_moe", "compressed"]


def _tiny(arch):
    common = dict(vocab_size=128, hidden_size=32, num_hidden_layers=2, num_attention_heads=4,
                  max_position_embeddings=128)
    if arch == "llama":
        cfg = transformers.LlamaConfig(**common, intermediate_size=64, num_key_value_heads=2,
                                       tie_word_embeddings=False)
        cls = transformers.LlamaForCausalLM
    elif arch == "opt":  # ties its output embedding: lm_head is None
        cfg = transformers.OPTConfig(**common, ffn_dim=64, word_embed_proj_dim=32)
        cls = transformers.OPTForCausalLM
    else:
        cfg = transformers.Qwen3MoeConfig(**common, intermediate_size=64, moe_intermediate_size=24,
                                          num_key_value_heads=2, num_experts=4, num_experts_per_tok=2,
                                          head_dim=8)
        cls = transformers.Qwen3MoeForCausalLM
    torch.manual_seed(0)
    return cls(cfg).eval()


@pytest.fixture(scope="module")
def trees():
    """arch -> (spec, JAX params, port params) of the same weights."""
    out = {}
    for arch in ARCHS[:3]:
        model = _tiny(arch)
        j_spec, j_params = j_params_from_hf(model)
        t_spec, t_params = t_params_from_hf(model, device="cpu")
        assert t_spec.to_dict() == j_spec.to_dict()
        out[arch] = (t_spec, j_params, t_params)
    j_spec, j_params, _ = j_artifact.load_compressed_model(os.path.join(FIXTURE, "npz"))
    t_spec, t_params, _ = t_artifact.load_compressed_model(os.path.join(FIXTURE, "npz"), device="cpu")
    assert len(set(t_spec.gate_ranks)) > 1  # heterogeneous ranks
    out["compressed"] = (t_spec, j_params, t_params)
    return out


def _flat(tree, path=""):
    """{path: leaf} of a JAX or port tree (None leaves kept)."""
    if isinstance(tree, dict):
        out = {}
        for k, v in tree.items():
            out.update(_flat(v, f"{path}/{k}"))
        return out
    if isinstance(tree, (list, tuple)):
        out = {}
        for i, v in enumerate(tree):
            out.update(_flat(v, f"{path}/{i}"))
        return out
    return {path: tree}


def _bits(leaf):
    """A leaf's dtype name and raw bits as numpy (bfloat16 as uint16)."""
    if isinstance(leaf, torch.Tensor):
        if leaf.dtype == torch.bfloat16:
            return "bfloat16", leaf.view(torch.int16).numpy().view(np.uint16)
        return str(leaf.numpy().dtype), leaf.numpy()
    a = np.asarray(leaf)
    if a.dtype.name == "bfloat16":
        return "bfloat16", a.view(np.uint16)
    return str(a.dtype), a


def _assert_same_tree(port, jax_tree):
    p, j = _flat(port), _flat(jax_tree)
    assert sorted(p) == sorted(j)
    for key in p:
        if p[key] is None or j[key] is None:
            assert p[key] is None and j[key] is None, key
            continue
        (pd, pa), (jd, ja) = _bits(p[key]), _bits(j[key])
        assert pd == jd, key
        np.testing.assert_array_equal(pa, ja, err_msg=key)


def _cast(port_tree, dtype):
    want = {"float32": torch.float32, "bfloat16": torch.bfloat16}[dtype]
    return {k: (v.to(want) if v is not None and v.is_floating_point() else v) for k, v in _flat(port_tree).items()}


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("arch", ARCHS)
def test_jax_orbax_artifact_loads_bit_for_bit(tmp_path, trees, arch, dtype):
    spec, j_params, _ = trees[arch]
    d = str(tmp_path / "jax")
    j_artifact.save_compressed_model(d, spec, j_params, "tok", {"m": 1}, dtype=dtype, backend="orbax")
    j_spec, want, _ = j_artifact.load_compressed_model(d)
    t_spec, got, tok = t_artifact.load_compressed_model(d, device="cpu")
    assert tok == "tok" and t_spec == spec and j_spec.to_dict() == spec.to_dict()
    assert isinstance(got["layers"], list) and ("lm_head" in got)
    _assert_same_tree(got, want)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("arch", ARCHS)
def test_port_orbax_artifact_loads_in_jax_bit_for_bit(tmp_path, trees, arch, dtype):
    spec, _, t_params = trees[arch]
    d = str(tmp_path / "port")
    t_artifact.save_compressed_model(d, spec, t_params, "tok", {"m": 1}, dtype=dtype, backend="orbax")
    j_dir = str(tmp_path / "jax")
    j_artifact.save_compressed_model(j_dir, spec, trees[arch][1], "tok", {"m": 1}, dtype=dtype, backend="orbax")
    with open(os.path.join(d, "spec.json")) as a, open(os.path.join(j_dir, "spec.json")) as b:
        assert json.load(a) == json.load(b)
    j_spec, got, tok = j_artifact.load_compressed_model(d)
    assert tok == "tok" and j_spec.to_dict() == spec.to_dict()
    assert sorted(os.listdir(os.path.join(d, "params_orbax"))) == [
        "_CHECKPOINT_METADATA", "_METADATA", "_sharding", "d", "manifest.ocdbt"]
    _assert_same_tree(_cast(t_params, dtype), _flat(got))
    # and back into the port
    _, again, _ = t_artifact.load_compressed_model(d, device="cpu")
    _assert_same_tree(_cast(again, dtype), _cast(t_params, dtype))


@pytest.mark.parametrize("dtype", ["int8", "int4", "nf4"])
def test_quantised_storage_with_orbax_raises(tmp_path, trees, dtype):
    spec, _, t_params = trees["llama"]
    with pytest.raises(ValueError, match=f"{dtype} quantization is supported by the npz backend only"):
        t_artifact.save_compressed_model(str(tmp_path / "a"), spec, t_params, dtype=dtype, backend="orbax")


def _job(cls, root, **kw):
    return cls(model="in-memory", dataset="synthetic", calib_size=8, calibs_batch_size=4, seq_len=64,
               eval_batch_size=4, eval_max_samples=8, compression_ratio=0.3, sparsity_smoothing=0.1,
               max_sparsity=0.8, output_dir=str(root / "out"), temp_storage_dir=str(root / "layers"),
               metrics_dir=str(root / "metrics"), **kw)


def test_orbax_job_matches_jax_and_npz(tmp_path, monkeypatch):
    """The compression CLI with --artifact_backend orbax end to end (its
    memory watchdog writes ./.mem-usage), against the JAX package's
    orbax job and the port's own npz job on the same weights."""
    model = _tiny("llama")
    hf_dir = str(tmp_path / "hf")
    model.save_pretrained(hf_dir, safe_serialization=True)
    j_spec, j_params = j_params_from_hf(model)
    t_spec, t_params = t_params_from_hf(model, device="cpu")
    want = j_run(_job(JConfig, tmp_path / "jax", artifact_backend="orbax"), spec=j_spec, params=j_params)
    npz = t_run(_job(TConfig, tmp_path / "npz", device="cpu"), spec=t_spec, params=t_params)

    monkeypatch.chdir(tmp_path)
    root = tmp_path / "cli"
    got = t_cli(["--model", hf_dir, "--dataset", "synthetic", "--calib_size", "8", "--calibs_batch_size", "4",
                 "--seq_len", "64", "--eval_batch_size", "4", "--eval_max_samples", "8",
                 "--compression_ratio", "0.3", "--sparsity_smoothing", "0.1", "--max_sparsity", "0.8",
                 "--artifact_backend", "orbax", "--output_dir", str(root / "out"),
                 "--temp_storage_dir", str(root / "layers"), "--metrics_dir", str(root / "metrics"),
                 "--device", "cpu"])
    assert os.path.exists(tmp_path / ".mem-usage")
    assert os.path.isdir(os.path.join(got["artifact_dir"], "params_orbax"))
    with open(os.path.join(got["artifact_dir"], "spec.json")) as f:
        assert json.load(f)["backend"] == "orbax"
    for ranks in ("q_ranks", "k_ranks", "v_ranks", "o_ranks", "gate_ranks"):
        assert getattr(got["compressed_spec"], ranks) == getattr(want["compressed_spec"], ranks), ranks
        assert getattr(got["compressed_spec"], ranks) == getattr(npz["compressed_spec"], ranks), ranks
    np.testing.assert_allclose(got["compressed_ppl"], want["compressed_ppl"], rtol=1e-3)
    np.testing.assert_allclose(got["compressed_ppl"], npz["compressed_ppl"], rtol=1e-6)
    _assert_same_tree(got["compressed_params"], npz["compressed_params"])


# ------------------------------------------------------------------- zstd

def _payload(kind, size, seed):
    rng = np.random.default_rng(seed)
    if kind == "random":
        return rng.integers(0, 256, size, dtype=np.uint8).tobytes()
    if kind == "bf16":
        x = rng.standard_normal(size // 2 + 1).astype(np.float32)
        return (x.view(np.uint32) >> 16).astype(np.uint16).tobytes()[:size]
    if kind == "f32":
        return rng.standard_normal(size // 4 + 1).astype(np.float32).tobytes()[:size]
    if kind == "text":
        words = [b"orbax", b"zarr", b"chunk", b"tensor", b"layer", b"kernel", b"\n"]
        return b" ".join(words[i] for i in rng.integers(0, len(words), size))[:size]
    return bytes(size)


_frames = st.lists(
    st.tuples(
        st.sampled_from([1, 3, 19]),
        st.sampled_from(["random", "bf16", "f32", "text", "zeros"]),
        st.one_of(st.integers(0, 300), st.integers(0, 1 << 20)),
        st.booleans(),  # content size in the header
        st.booleans(),  # content checksum
        st.integers(0, 2**31),
    ),
    min_size=1, max_size=3,
)


@settings(max_examples=25, deadline=None, database=None, suppress_health_check=[HealthCheck.too_slow])
@given(_frames)
def test_zstd_decoder_matches_zstandard(frames):
    data, src = b"", b""
    for level, kind, size, with_size, checksum, seed in frames:
        d = _payload(kind, size, seed)
        c = zstandard.ZstdCompressor(level=level, write_content_size=with_size, write_checksum=checksum)
        data, src = data + d, src + c.compress(d)
    assert zstd.decompress(src) == data
    out = np.empty(len(data), dtype=np.uint8)
    assert zstd.decompress_into(src, out) == len(data) and out.tobytes() == data


def test_zstd_corrupt_input_raises():
    data = _payload("bf16", 200_000, 0)
    frame = zstandard.ZstdCompressor(level=3, write_checksum=True).compress(data)
    for bad in (frame[:-1], frame[: len(frame) // 2], frame[:10], b"\x00" + frame[1:]):
        with pytest.raises(ValueError, match="zstd"):
            zstd.decompress(bad)
    flipped = bytearray(frame)
    flipped[-2] ^= 0xFF  # the content checksum
    with pytest.raises(ValueError, match="checksum"):
        zstd.decompress(bytes(flipped))
    with pytest.raises(ValueError, match="more than"):
        zstd.decompress_into(frame, np.empty(len(data) - 1, np.uint8))
    # random damage anywhere: a checksummed frame decodes exactly or raises
    rng = np.random.default_rng(1)
    for _ in range(200):
        damaged = bytearray(frame)
        for i in rng.integers(0, len(frame), int(rng.integers(1, 4))):
            damaged[i] ^= int(rng.integers(1, 256))
        try:
            assert zstd.decompress(bytes(damaged), max_size=1 << 22) == data
        except ValueError:
            pass
    assert zstd.xxh64(b"") == 0xEF46DB3751D8E999


# ------------------------------------------------------------------ OCDBT

def test_ocdbt_round_trip_over_several_nodes(tmp_path):
    rng = np.random.default_rng(0)
    entries = {
        f"layers.{i % 23}.{'qkv'[i % 3]}.kernel/{i}": rng.integers(0, 256, int(rng.integers(0, 2500)),
                                                                  dtype=np.uint8).tobytes()
        for i in range(400)
    }
    root = str(tmp_path / "store")
    ocdbt.write_store(root, entries, max_node_bytes=800)
    got = ocdbt.OcdbtReader(root)
    assert got.version.root_height >= 2  # the keys overflow one leaf, and one interior node
    assert got.keys() == sorted(entries)
    assert all(got.read(k) == v for k, v in entries.items())
    kv = tensorstore.KvStore.open({"driver": "ocdbt", "base": {"driver": "file", "path": root}}).result()
    assert sorted(k.decode() for k in kv.list().result()) == sorted(entries)
    assert all(kv.read(k).result().value == v for k, v in entries.items())


@pytest.mark.parametrize("compression", [None, {"id": "zstd"}], ids=["raw", "zstd"])
def test_ocdbt_reads_tensorstore_stores(tmp_path, compression):
    """A per-process store written one key at a time (a version each:
    version-tree nodes), with small nodes (interior nodes) and small
    inline values, then merged into the top store as orbax merges, whose
    leaves point into the per-process directory."""
    cfg = {"max_inline_value_bytes": 16, "max_decoded_node_bytes": 400, "version_tree_arity_log2": 2,
           "compression": compression}
    ctx = tensorstore.Context()

    def store(path):
        spec = {"driver": "ocdbt", "base": {"driver": "file", "path": path}, "config": cfg}
        return tensorstore.KvStore.open(spec, context=ctx).result()

    root = str(tmp_path / "ckpt")
    child = store(os.path.join(root, "ocdbt.process_0"))
    rng = np.random.default_rng(2)
    entries = {}
    for i in range(60):
        key = f"key{i:03d}/" + "x" * (i % 7)
        entries[key] = rng.integers(0, 256, int(rng.integers(0, 60)), dtype=np.uint8).tobytes()
        child.write(key, entries[key]).result()
    txn = tensorstore.Transaction(atomic=True)
    child.experimental_copy_range_to(store(root).with_transaction(txn)).result()
    txn.commit_async().result()
    for path in (root, os.path.join(root, "ocdbt.process_0")):
        got = ocdbt.OcdbtReader(path)
        assert got.keys() == sorted(entries)
        assert all(got.read(k) == v for k, v in entries.items())
    per_process = ocdbt.OcdbtReader(os.path.join(root, "ocdbt.process_0"))
    assert per_process.version.generation == 61
    assert [v.generation for v in per_process.versions()] == list(range(1, 61))
    assert any(isinstance(v, ocdbt.ValueRef) and v.path.startswith("ocdbt.process_0/")
               for v in ocdbt.OcdbtReader(root).values.values())


@pytest.mark.parametrize("dtype", ["<f4", "bfloat16", "<i4"])
@pytest.mark.parametrize("compressor", [None, {"id": "zstd", "level": 3}], ids=["raw", "zstd"])
def test_zarr_chunk_grids_read_as_tensorstore_reads_them(tmp_path, dtype, compressor):
    """An array split over a chunk grid with partial edge chunks and
    chunks never written (the fill value), as JAX on several devices
    saves a sharded leaf: the port's read equals tensorstore's."""
    from modegpt_tpu_torch.compress import orbax_format

    root = str(tmp_path / "store")
    spec = {"driver": "zarr", "kvstore": {"driver": "ocdbt", "base": {"driver": "file", "path": root}},
            "path": "layers.0.q.kernel",
            "metadata": {"shape": [9, 13], "chunks": [4, 5], "dtype": dtype, "compressor": compressor,
                         "dimension_separator": "."},
            "create": True}
    arr = tensorstore.open(spec).result()
    rng = np.random.default_rng(3)
    np_dtype = {"<f4": np.float32, "<i4": np.int32, "bfloat16": arr.dtype.numpy_dtype}[dtype]
    values = (rng.standard_normal((9, 13)) * 100).astype(np_dtype)
    arr[:, :10] = values[:, :10]  # the last column of chunks is never written
    want = np.asarray(arr.read().result())
    assert not want[:, 10:].any()
    got = orbax_format._read_array(ocdbt.OcdbtReader(root), "layers.0.q.kernel")
    assert _bits(got)[1].tobytes() == _bits(want)[1].tobytes()


def test_ocdbt_corrupt_record_raises(tmp_path):
    root = str(tmp_path / "store")
    ocdbt.write_store(root, {"a/.zarray": b"{}", "a/0": bytes(3000)})
    path = os.path.join(root, "manifest.ocdbt")
    with open(path, "rb") as f:
        buf = bytearray(f.read())
    buf[20] ^= 1
    with open(path, "wb") as f:
        f.write(buf)
    with pytest.raises(ValueError, match="CRC-32C"):
        ocdbt.OcdbtReader(root)
    assert ocdbt.crc32c(b"123456789") == 0xE3069283  # the CRC-32C check value


# ---------------------------------------------------------------- fixture

@pytest.mark.parametrize("variant", ["f32", "bf16"])
def test_jax_written_fixture_loads_equal_to_its_npz_twin(tmp_path, variant):
    dtype = "float32" if variant == "f32" else "bfloat16"
    spec, twin, _ = t_artifact.load_compressed_model(os.path.join(FIXTURE, "npz"), device="cpu")
    t_spec, got, _ = t_artifact.load_compressed_model(os.path.join(FIXTURE, variant), device="cpu")
    assert t_spec == spec
    _assert_same_tree(_cast(got, dtype), _cast(twin, dtype))
    # the JAX package still writes (and reads) these values
    j_spec, j_twin, _ = j_artifact.load_compressed_model(os.path.join(FIXTURE, "npz"))
    d = str(tmp_path / "again")
    j_artifact.save_compressed_model(d, j_spec, j_twin, "tok", dtype=dtype, backend="orbax")
    _, again, _ = t_artifact.load_compressed_model(d, device="cpu")
    _assert_same_tree(_cast(again, dtype), _cast(got, dtype))
    _, j_fixture, _ = j_artifact.load_compressed_model(os.path.join(FIXTURE, variant))
    _assert_same_tree(_cast(got, dtype), _flat(j_fixture))


# ------------------------------------------------ solve_layer, diagnostics

def _calibrated(arch):
    """(spec, JAX params, port params, JAX calibration, the same Grams as
    the port's CalibrationResult): both solvers see identical inputs."""
    model = _tiny(arch)
    j_spec, j_params = j_params_from_hf(model)
    t_spec, t_params = t_params_from_hf(model, device="cpu")
    batches = load_calibration_batches(None, "synthetic", 8, 4, 32, vocab_size=128)
    j_calib = j_calibrate(j_spec, j_params, batches, [0, 1])
    t_calib = t_calibrate(t_spec, t_params, batches, [0, 1])
    for field in ("cov_mlp", "cov_q", "cov_k", "cov_x", "cov_shared"):
        getattr(t_calib, field).update({l: torch.from_numpy(np.asarray(g)) for l, g in getattr(j_calib, field).items()})
    return t_spec, j_params, t_params, j_calib, t_calib


@pytest.mark.parametrize("arch", ["llama", "opt", "qwen3_moe"])
def test_solve_layer_matches_jax(arch):
    spec, j_params, t_params, j_calib, t_calib = _calibrated(arch)
    j_cfg, t_cfg = JConfig(solver_precision="f64_cpu"), TConfig(solver_precision="f64_cpu", device="cpu")
    for l, keep in ((0, 0.6), (1, 0.8)):
        want = j_solve_layer(spec, j_params["layers"][l], l, keep, j_calib, j_cfg, "mlp,qk,vo")
        got = t_solve_layer(spec, t_params["layers"][l], l, keep, t_calib, t_cfg, "mlp,qk,vo")
        assert sorted(got) == sorted(want)
        for s in want:
            assert sorted(got[s]) == sorted(want[s]), s
            for key, w in want[s].items():
                g, w = np.asarray(got[s][key]), np.asarray(w)
                if key in ("idx", "shared_idx", "rotary_mask"):
                    np.testing.assert_array_equal(g, w, err_msg=f"{s}/{key}")
                elif s == "vo" and key in ("v", "o"):
                    continue  # an SVD sign per basis vector: the product is compared below
                else:
                    np.testing.assert_allclose(g, w, rtol=1e-8, atol=1e-10 * np.abs(w).max(),
                                               err_msg=f"{s}/{key}")
        # each head's O_h V_h is invariant to the signs of the SVD basis
        gv, go = got["vo"]["v"], got["vo"]["o"]
        wv, wo = np.asarray(want["vo"]["v"]), np.asarray(want["vo"]["o"])
        r = gv.shape[0] // spec.n_kv_heads
        for h in range(spec.n_heads):
            kv = slice(h // spec.group_size * r, (h // spec.group_size + 1) * r)
            prod_w = wo[:, h * r:(h + 1) * r] @ wv[kv]
            np.testing.assert_allclose(go[:, h * r:(h + 1) * r] @ gv[kv], prod_w, rtol=1e-8,
                                       atol=1e-10 * np.abs(prod_w).max(), err_msg=f"head {h}")


def test_psd_diagnostics_and_the_debug_log_match_jax(caplog):
    spec, j_params, t_params, j_calib, t_calib = _calibrated("llama")
    for field, ridge in (("cov_mlp", 1e-6), ("cov_x", 1e-4)):
        m = getattr(t_calib, field)[0]
        for scaled in (False, True):
            want = j_psd_diagnostics(np.asarray(getattr(j_calib, field)[0]), ridge, scaled)
            got = t_psd_diagnostics(m, ridge, scaled)
            assert got.keys() == want.keys() and got["is_psd"] == want["is_psd"]
            for k in ("max_eig", "min_eig", "mean_eig", "cond_pre", "cond_post"):
                np.testing.assert_allclose(got[k], want[k], rtol=1e-8, err_msg=f"{field} {k}")
    cfg = TConfig(solver_precision="f64_cpu", device="cpu", debug=True)
    with caplog.at_level(logging.INFO, logger="modegpt_tpu_torch"):
        t_solve_chunk(spec, t_params, [0, 1], [0.6, 0.8], t_calib, cfg, "mlp,qk,vo")
    lines = [r.getMessage() for r in caplog.records if "[debug]" in r.getMessage()]
    assert [ln.split(":")[0] for ln in lines] == [
        "[debug] layer 0 cov_mlp", "[debug] layer 0 cov_x", "[debug] layer 1 cov_mlp", "[debug] layer 1 cov_x"]
    assert str(t_psd_diagnostics(t_calib.cov_x[1], cfg.ridge_vo)) in lines[-1]


def test_memory_watchdog_writes_its_file_and_stops(tmp_path):
    path = str(tmp_path / ".mem-usage")
    stop = threading.Event()
    t = start_memory_watchdog(path=path, interval_s=0.05, stop_event=stop, devices=[torch.device("cpu")])
    try:
        for _ in range(200):
            if os.path.exists(path) and os.path.getsize(path):
                break
            stop.wait(0.05)
        with open(path) as f:
            text = f.read()
        assert "Process RAM" in text and "System RAM" in text
    finally:
        stop.set()
        t.join(timeout=10)
    assert not t.is_alive() and t._stop_event is stop
