"""Measurement tools of the port, each run as `python -m pbf_sph_tpu_torch.tools.<name>`."""
