"""The compression job: layer solves, surgery, artifacts and the pipeline driver."""
