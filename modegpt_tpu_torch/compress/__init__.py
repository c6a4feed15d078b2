"""The compression job: layer solves, surgery, artifacts, the streamed and
fused jobs and the pipeline's entry point."""
