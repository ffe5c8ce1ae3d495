"""paths_tpu_torch: the PyTorch/CUDA port of `paths_tpu`, for NVIDIA Hopper.

Module layout and names mirror `paths_tpu` so that each piece has an obvious
counterpart. The port imports torch and numpy only: nothing from JAX and
nothing from `paths_tpu`. Entry points run on "cuda" unless the caller asks
for the CPU; on the CPU each hand-written kernel is replaced by its plain
PyTorch version, on a CUDA tensor the kernel runs or the call raises.
"""

__version__ = "0.1.0"
