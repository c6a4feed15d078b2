"""Time variants of an attention source against each other on the card.

    python -m modegpt_tpu_torch.kernels.compare a.cu b.cu@-fmad=false [...] [--sass DIR]

Each file is a variant of one of the package's CUDA sources, told apart
by the C entry it exports:

* ``modegpt_flash_attention_hbm`` (``csrc/flash_attention_hbm.cu``): the
  T = 16384 cases of ``chip_smoke.py``'s K2 table run on every variant;
* ``modegpt_ragged_gqa_attend`` (``csrc/ragged_decode.cu``, with its
  ``modegpt_ragged_gqa_workspace``): ``chip_smoke.py``'s K3 decode and
  chunk cases, and its row sweep: every decode form in use, at G*S of
  1, 2, 3, 4, 5, 8, 12 and 16 query rows a kv head.

All variants build at once with the package's nvcc flags (into the
directory of the first file; ``csrc/`` is on the include path, so a copy
kept elsewhere still finds ``ptx.cuh``). ``file.cu@flag@flag`` adds nvcc
flags to one variant (``b.cu@-fmad=false``), so one source can be built
two ways. ``--sass DIR`` writes each library's ``cuobjdump -sass``,
gzipped, to ``DIR/<variant>.sass.gz``, and the ptxas report of each
build goes to stderr. Every case runs on every
variant in turn, on the same seeded inputs, and each line gives the ms
per launch, the largest difference from the first variant's output and,
for K3, from the plain version's. K3's launches go into preallocated
output and scratch, so that its few-microsecond grids are timed rather
than the host's enqueue. The card's name, power limit and
clocks close the output. It needs one NVIDIA card.
"""

from __future__ import annotations

import ctypes
import gzip
import os
import subprocess
import sys

import numpy as np
import torch

from modegpt_tpu_torch.kernels.build import CSRC_DIR, NVCC_FLAGS, _nvcc

# K2: name, H, Hk, T, hd, hd_v, dtype (B = 1, causal)
CASES = [
    ("long_f32", 32, 8, 16384, 128, 128, torch.float32),
    ("long_padded_f32", 32, 8, 16384, 126, 126, torch.float32),
    ("long_bf16", 32, 8, 16384, 128, 128, torch.bfloat16),
    ("long_compressed_f32", 32, 8, 16384, 88, 90, torch.float32),
    ("long_compressed_bf16", 32, 8, 16384, 88, 90, torch.bfloat16),
]
# K3: chip_smoke.py's decode and chunk cases; pos None draws B positions
# over the pool, "edge" puts slot 1 past its end
_DECODE = dict(B=8, H=32, Hk=8, T=1024, S=1, Rq=126, Rv=126, dtype=torch.float32, window=None, softcap=None,
               int8=False, pos=None)
RAGGED_CASES = [
    dict(_DECODE, name="decode_f32"),
    dict(_DECODE, name="decode_bf16", dtype=torch.bfloat16),
    dict(_DECODE, name="int8_f32", int8=True),
    dict(_DECODE, name="mha", Hk=32),
    # the archs phase's served shapes: multi-head attention at published
    # widths (one query row a kv head), GQA groups of 7 and 9, and the
    # soft-capped Gemma-2-9B stack at ranks of 256
    dict(_DECODE, name="mha_gemma7b_r256", H=16, Hk=16, Rq=256, Rv=256),
    dict(_DECODE, name="mha_phi3_r96", Hk=32, Rq=96, Rv=96),
    dict(_DECODE, name="mha_gpt2xl_H25_r64", H=25, Hk=25, Rq=64, Rv=64),
    dict(_DECODE, name="qwen2_G7", H=28, Hk=4, Rq=128, Rv=128),
    dict(_DECODE, name="starcoder2_G9", H=36, Hk=4, Rq=128, Rv=128),
    dict(_DECODE, name="gemma2_softcap_r256", H=16, Hk=8, Rq=256, Rv=256, softcap=50.0),
    dict(_DECODE, name="gemma2_chunk_softcap_r256", H=16, Hk=8, Rq=256, Rv=256, softcap=50.0, B=1, S=128,
         pos=[384]),
    dict(_DECODE, name="edge_row", pos="edge"),
    dict(_DECODE, name="window100", window=100),
    dict(_DECODE, name="decode_T4096", T=4096),
    dict(_DECODE, name="chunk_S128_pos384", B=1, S=128, pos=[384]),
    dict(_DECODE, name="chunk_S128_bf16", B=1, S=128, pos=[384], dtype=torch.bfloat16),
    dict(_DECODE, name="chunk_S128_pos384_int8", B=1, S=128, pos=[384], int8=True),
    dict(_DECODE, name="chunk_S128_pos0", B=1, S=128, pos=[0]),
]
# the decode forms' row sweep: (G, S) with G*S = 1, 2, 3, 4, 5, 8, 12, 16
# rows a kv head (H = 32 over 32 / G kv heads), queries at pos .. pos+S-1
ROW_SWEEP = [(1, 1), (2, 1), (1, 3), (4, 1), (1, 5), (8, 1), (4, 3), (8, 2)]
RAGGED_CASES += [
    dict(_DECODE, name=f"rows{G * S}_G{G}_S{S}", Hk=32 // G, S=S) for G, S in ROW_SWEEP
]
# the one-row form in the pool's other dtypes
RAGGED_CASES += [
    dict(_DECODE, name="rows1_G1_S1_bf16", Hk=32, dtype=torch.bfloat16),
    dict(_DECODE, name="rows1_G1_S1_int8", Hk=32, int8=True),
    dict(_DECODE, name="rows1_G1_S1_int8_bf16", Hk=32, int8=True, dtype=torch.bfloat16),
]
_ENTRIES = ("modegpt_flash_attention_hbm", "modegpt_ragged_gqa_attend")


def _label(variant: str) -> str:
    """A variant's name: its file's base name, then its extra flags."""
    src, *flags = variant.split("@")
    return "@".join([os.path.basename(src), *flags])


def build(variants, sass_dir=None):
    """(entry name, [library per variant]) built in parallel; raises with
    nvcc's output on a failed build or on variants of different sources.
    A variant is a source path, then any extra nvcc flags after "@"."""
    out_dir = os.path.dirname(os.path.abspath(variants[0].split("@")[0]))
    procs = []
    for variant in variants:
        src, *flags = variant.split("@")
        lib = os.path.join(out_dir, _label(variant).replace("=", "_") + ".so")
        cmd = [_nvcc(), *NVCC_FLAGS, *flags, "-I", CSRC_DIR, "-o", lib, src]
        procs.append((variant, lib, subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT)))
    libs, entries = [], set()
    for variant, lib, proc in procs:
        log = proc.communicate()[0].decode(errors="replace")
        if proc.returncode:
            raise RuntimeError(f"nvcc failed for {variant}:\n{log}")
        print(f"[ptxas {_label(variant)}]\n{log}", file=sys.stderr)
        if sass_dir:
            os.makedirs(sass_dir, exist_ok=True)
            cuobjdump = os.path.join(os.path.dirname(_nvcc()), "cuobjdump")
            dump = subprocess.run([cuobjdump, "-sass", lib], capture_output=True, check=False)
            with gzip.open(os.path.join(sass_dir, _label(variant) + ".sass.gz"), "wb") as f:
                f.write(dump.stdout + dump.stderr)
        cdll = ctypes.CDLL(lib)
        found = [e for e in _ENTRIES if hasattr(cdll, e)]
        if len(found) != 1:
            raise RuntimeError(f"{src} exports {found or 'none'} of {_ENTRIES}")
        entries.add(found[0])
        libs.append(cdll)
    if len(entries) != 1:
        raise RuntimeError(f"the variants are of different sources: {sorted(entries)}")
    return entries.pop(), libs


def _hbm_fn(lib):
    fn = lib.modegpt_flash_attention_hbm
    fn.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 6 + [ctypes.c_float, ctypes.c_int, ctypes.c_int, ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


def launch(fn, q, k, v):
    B, H, T, hd = q.shape
    o = torch.empty((B, H, T, v.shape[-1]), dtype=q.dtype, device=q.device)
    scale = float(torch.tensor(hd**-0.5, dtype=q.dtype))
    err = fn(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(), B, H, k.shape[1], T, hd, v.shape[-1],
        scale, 0, 0 if q.dtype == torch.float32 else 1, torch.cuda.current_stream().cuda_stream,
    )
    if err:
        raise RuntimeError(f"launch failed: CUDA error {err}")
    return o


def _ragged_launcher(lib):
    """prepare(q, k, v, pos, k_scale, v_scale, window, softcap) -> a callable that
    launches one variant's kernels into preallocated output and scratch
    and returns the output, so that the timed loop is the launches."""
    fn, ws_fn = lib.modegpt_ragged_gqa_attend, lib.modegpt_ragged_gqa_workspace
    fn.argtypes = [ctypes.c_void_p] * 8 + [ctypes.c_int] * 8 + [ctypes.c_float, ctypes.c_int, ctypes.c_void_p]
    fn.restype = ctypes.c_int
    ws_fn.argtypes = [ctypes.c_int] * 7
    ws_fn.restype = ctypes.c_longlong

    def prepare(q, k, v, pos, ks, vs, window, softcap=None):
        B, H, S, Rq = q.shape
        Hk, T, Rv = k.shape[1], k.shape[2], v.shape[-1]
        o = torch.empty((B, H, S, Rv), dtype=q.dtype, device=q.device)
        ws = torch.empty(ws_fn(B, H, Hk, S, T, Rq, Rv), dtype=torch.float32, device=q.device)
        args = (
            q.data_ptr(), k.data_ptr(), v.data_ptr(), 0 if ks is None else ks.data_ptr(),
            0 if vs is None else vs.data_ptr(), pos.data_ptr(), o.data_ptr(), ws.data_ptr(),
            B, H, Hk, S, T, Rq, Rv, window or 0, softcap or 0.0, 0 if q.dtype == torch.float32 else 1,
            torch.cuda.current_stream().cuda_stream,
        )

        def run():
            err = fn(*args)
            if err:
                raise RuntimeError(f"launch failed: CUDA error {err}")
            return o
        return run
    return prepare


def ms_per_launch(fn, iters: int = 5) -> float:
    fn()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def _compare_hbm(names, libs, gen) -> None:
    fns = [_hbm_fn(lib) for lib in libs]
    for name, H, Hk, T, hd, hd_v, dt in CASES:
        q = torch.randn((1, H, T, hd), generator=gen, device="cuda").to(dt)
        k = torch.randn((1, Hk, T, hd), generator=gen, device="cuda").to(dt)
        v = torch.randn((1, Hk, T, hd_v), generator=gen, device="cuda").to(dt)
        first = None
        cells = []
        for label, fn in zip(names, fns):
            out = launch(fn, q, k, v).float()
            first = out if first is None else first
            diff = float((out - first).abs().max())
            t = ms_per_launch(lambda: launch(fn, q, k, v))
            cells.append(f"{label} {t:.3f} ms (diff {diff:.1e})")
        print(f"{name}: " + "; ".join(cells), flush=True)


def _compare_ragged(names, libs) -> None:
    from modegpt_tpu_torch.kernels.ragged_decode import ragged_gqa_attend_reference

    runs = [_ragged_launcher(lib) for lib in libs]
    rng = np.random.default_rng(0)
    for case in RAGGED_CASES:
        B, H, Hk, T, S, Rq, Rv = (case[k] for k in ("B", "H", "Hk", "T", "S", "Rq", "Rv"))
        if case["pos"] is None or case["pos"] == "edge":
            pos_host = rng.integers(0, T, size=B).tolist()
            if case["pos"] == "edge":
                pos_host[1] = T + 5
        else:
            pos_host = list(case["pos"])

        def t(a):
            return torch.from_numpy(np.ascontiguousarray(a)).cuda()

        q = t((rng.standard_normal((B, H, S, Rq)) * Rq**-0.5).astype(np.float32)).to(case["dtype"])
        if case["int8"]:
            k, v = (t(rng.integers(-127, 128, (B, Hk, T, r), dtype=np.int8)) for r in (Rq, Rv))
            ks, vs = (t((rng.uniform(0.5, 1.5, (B, Hk, T)) / 127).astype(np.float32)) for _ in range(2))
        else:
            k, v = (t(rng.standard_normal((B, Hk, T, r)).astype(np.float32)).to(case["dtype"]) for r in (Rq, Rv))
            ks = vs = None
        pos = torch.tensor(pos_host, dtype=torch.int32, device="cuda")
        w, cap = case["window"], case["softcap"]
        plain = ragged_gqa_attend_reference(q, k, v, pos, ks, vs, window=w, softcap=cap).float()
        first = None
        cells = []
        for label, prepare in zip(names, runs):
            run = prepare(q, k, v, pos, ks, vs, w, cap)
            out = run().float()
            first = out if first is None else first
            diff = float((out - first).abs().max())
            err = float((out - plain).abs().max())
            ms = ms_per_launch(run, iters=200)
            cells.append(f"{label} {ms:.4f} ms (diff {diff:.1e}, vs plain {err:.1e})")
        print(f"{case['name']}: " + "; ".join(cells), flush=True)


def main(argv) -> int:
    sass_dir = None
    if "--sass" in argv:
        i = argv.index("--sass")
        sass_dir = argv[i + 1]
        argv = argv[:i] + argv[i + 2:]
    if not argv or not torch.cuda.is_available():
        print(__doc__, file=sys.stderr)
        return 2
    entry, libs = build(argv, sass_dir)
    names = [_label(v) for v in argv]
    gen = torch.Generator(device="cuda").manual_seed(0)
    x = torch.randn(8192, 8192, device="cuda", generator=gen)
    for _ in range(50):  # bring the clocks up before the first case
        x @ x
    del x
    if entry == "modegpt_flash_attention_hbm":
        _compare_hbm(names, libs, gen)
    else:
        _compare_ragged(names, libs)
    smi = ["nvidia-smi", "--query-gpu=name,power.limit,clocks.sm,clocks.max.sm", "--format=csv,noheader"]
    print(subprocess.run(smi, capture_output=True, text=True).stdout.strip())
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
