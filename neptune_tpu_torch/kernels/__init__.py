"""Generation and nvcc build of the Hopper kernels' CUDA sources."""
