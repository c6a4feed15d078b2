"""Command-line entry point: ``python -m modegpt_tpu_torch.cli [flags]``.

Takes the same flags as ``python -m modegpt_tpu.cli`` (one per
`CompressionConfig` field); ``--device`` is a torch device ("cuda" by
default, "cuda:N", N, or "cpu").
"""

from __future__ import annotations

import logging


def main(argv=None):
    from modegpt_tpu_torch.compress.pipeline import run_compression
    from modegpt_tpu_torch.config import CompressionConfig
    from modegpt_tpu_torch.utils.logging import setup_logging

    config = CompressionConfig.from_args(argv)
    logger = setup_logging(level=logging.DEBUG if config.debug else logging.INFO)
    logger.info("config: %s", config.to_dict())
    results = run_compression(config)
    summary = {
        k: v
        for k, v in results.items()
        if k in ("baseline_ppl", "compressed_ppl", "compress_seconds", "total_seconds", "artifact_dir")
    }
    logger.info("done: %s", summary)
    return results


if __name__ == "__main__":
    main()
