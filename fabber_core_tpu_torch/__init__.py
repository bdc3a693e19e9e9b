"""fabber_core_tpu_torch — the PyTorch/CUDA port of fabber_core_tpu.

Batched voxelwise Variational Bayes over fixed-design forward models,
with the whole-program spectral route running on two hand-written CUDA
kernels for Hopper (ops/fused_spectral.py, csrc/). The JAX package
beside it (fabber_core_tpu) is the reference this port is held
against; the port imports torch, numpy and scipy, never jax.

Key entry points (the device is always explicit; nothing falls back
from "cuda" to the CPU):
  - fabber_core_tpu_torch.api.FabberTpu(device=...).run_with_data(...)
  - python -m fabber_core_tpu_torch.cli --device=cuda ...
  - fabber_core_tpu_torch.inference.vb.VBInference(..., device=...)
"""

import torch

# The JAX package pins "highest" matmul precision because single-pass
# bf16 moved the posteriors by 2.5 sd (fabber_core_tpu/__init__.py).
# The counterpart here is to keep every float32 matmul and convolution
# out of TF32, which keeps only ~3 decimal digits.
torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False

from .version import __version__  # noqa: E402,F401
from .exceptions import FabberError  # noqa: E402


def resolve_device(name="cuda"):
    """torch.device for a user-supplied name ("cuda", "cuda:1", "cpu").

    "cuda" with no usable card raises: the port never falls back to
    the CPU, so a run asked for the card either runs there or fails."""
    dev = torch.device(name)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise FabberError(
                f"device '{name}' requested but torch.cuda.is_available() "
                "is False")
        if dev.index is None:   # tensors report an indexed device
            dev = torch.device("cuda", torch.cuda.current_device())
    elif dev.type != "cpu":
        raise FabberError(f"Unsupported device '{name}' (cuda or cpu)")
    return dev
