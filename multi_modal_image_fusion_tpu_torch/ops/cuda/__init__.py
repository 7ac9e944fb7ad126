"""Hand-written Hopper kernels (csrc/) with their wrappers and plain
versions. Importing these modules builds nothing: the library is compiled
and loaded at the first launch on a CUDA tensor (build.py)."""
