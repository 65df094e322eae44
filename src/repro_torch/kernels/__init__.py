"""Hand-written Hopper kernels of the port (CUDA C++ under csrc/, bound
with ctypes), each beside its plain torch version."""
