"""The port's C++/OpenMP oracle: `csrc/ompsph.cpp`, built by `build.py`."""
