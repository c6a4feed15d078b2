"""Command-line entry point: ``python -m modegpt_tpu_torch.cli [flags]``.

Takes the same flags as ``python -m modegpt_tpu.cli`` (one per
`CompressionConfig` field); ``--device`` is a torch device ("cuda" by
default, "cuda:N", N, or "cpu").

A mesh job (``--mesh_shape data:2,model:2``) runs one process per rank
(`parallel.mesh.maybe_initialize_distributed`)::

    python -m torch.distributed.run --nproc_per_node 4 -m modegpt_tpu_torch.cli \
        --mesh_shape data:2,model:2 ...

NCCL with a card per rank; ranks that share a card need
``MODEGPT_DIST_BACKEND=gloo``.

While the job runs, a watchdog thread rewrites ``./.mem-usage`` every
second with the host RSS and the rank's card's bytes
(`utils.memory.start_memory_watchdog`), as the JAX CLI's does.
"""

from __future__ import annotations

import logging


def main(argv=None):
    import torch.distributed as dist

    from modegpt_tpu_torch.compress.pipeline import run_compression
    from modegpt_tpu_torch.config import CompressionConfig
    from modegpt_tpu_torch.parallel.mesh import maybe_initialize_distributed, rank_device
    from modegpt_tpu_torch.utils.logging import setup_logging
    from modegpt_tpu_torch.utils.memory import start_memory_watchdog

    config = CompressionConfig.from_args(argv)
    logger = setup_logging(level=logging.DEBUG if config.debug else logging.INFO)
    joined = maybe_initialize_distributed(config.device)
    # after the distributed init, which binds this rank to its card
    watchdog = start_memory_watchdog(devices=[rank_device(config.device)])
    try:
        if joined:
            logger.info("torch.distributed: rank %d of %d, backend %s",
                        dist.get_rank(), dist.get_world_size(), dist.get_backend())
            if dist.get_world_size() > 1 and not config.mesh_shape:
                raise ValueError("a job launched over several ranks needs --mesh_shape")
        logger.info("config: %s", config.to_dict())
        results = run_compression(config)  # builds this rank's mesh from --mesh_shape
    finally:
        watchdog._stop_event.set()
        if joined:
            dist.destroy_process_group()
    summary = {
        k: v
        for k, v in results.items()
        if k in ("baseline_ppl", "compressed_ppl", "compress_seconds", "total_seconds", "artifact_dir")
    }
    logger.info("done: %s", summary)
    return results


if __name__ == "__main__":
    main()
