"""phylo_tpu_torch: the PyTorch/CUDA port of phylo_tpu.

Variational combinatorial SMC (VCSMC) for Bayesian phylogenetics on an
NVIDIA Hopper GPU.  The module layout mirrors ``phylo_tpu`` file for
file (``phylo_tpu_torch/smc/sweep.py`` is the counterpart of
``phylo_tpu/smc/sweep.py``); the JAX package stays the reference the
port is held against.

Every Pallas kernel on the training path has a hand-written CUDA C++
counterpart under ``csrc/`` (built with nvcc at first use, see
``_ext.py``) and a plain PyTorch version beside its wrapper.  A wrapper
takes the plain version only for CPU tensors; a CUDA tensor reaches its
kernel or the call raises.

Entry points run on ``cuda`` unless the caller passes ``device="cpu"``.
"""

__version__ = "0.1.0"
