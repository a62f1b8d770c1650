"""PyTorch/CUDA port of disinfect_slam_tpu: semantic sparse voxel-block
TSDF fusion whose kernels are written by hand for NVIDIA Hopper
(csrc/*.cu).  The JAX package beside it is the reference."""
