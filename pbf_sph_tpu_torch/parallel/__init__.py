"""Multi-device engines of the port: the 1D slab decomposition
(`sharded.py`) over a small transport (`comm.py`)."""
