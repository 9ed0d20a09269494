"""Wrapper of the FM interaction CUDA kernel (``csrc/fm_interaction.cu``);
counterpart of ``repro.kernels.fm_interaction.ops``.

``fm_interaction(emb)`` returns ``out [B]`` float32 with
``out[b] = 0.5 * sum_d((sum_f e[b,f,d])^2 - sum_f e[b,f,d]^2)`` for
``emb [B, F, D]`` (cast to float32, made contiguous).  The reference pads
B to a multiple of its 128-row tile; the kernel masks the ragged edge
instead, so any B >= 0 goes as it is.

The launch is a raw pointer call that autograd cannot see, and the
kernel has no backward yet: on the card the wrapper raises for an input
that requires grad while grad mode is on (serve under
``torch.inference_mode()`` or ``torch.no_grad()``).  The CPU
path is the plain version and stays differentiable.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import common
from repro_torch.kernels.fm_interaction.ref import fm_interaction_ref

NAME = "fm_interaction"


def _lib():
    fn = common.library(NAME).fm_interaction
    if fn.argtypes is None:
        p, i64 = ctypes.c_void_p, ctypes.c_int64
        fn.argtypes = [p, i64, i64, i64, p, p]
        fn.restype = ctypes.c_int
    return fn


def fm_interaction(emb: torch.Tensor) -> torch.Tensor:
    """Second-order FM term per row of ``emb [B, F, D]`` (F, D >= 1) as a
    float32 ``[B]`` on ``emb``'s device; see the module docstring."""
    if not isinstance(emb, torch.Tensor):
        raise TypeError(f"emb: expected a tensor, got {type(emb).__name__}")
    emb = emb.to(torch.float32).contiguous()
    common.check_tensor(emb, "emb", torch.float32, emb.device, ndim=3)
    b, f, d = (int(x) for x in emb.shape)
    if f < 1 or d < 1:
        raise ValueError(
            f"emb: need F >= 1 and D >= 1, got {tuple(emb.shape)}")
    if not common.kernel_device(emb, NAME):
        return fm_interaction_ref(emb)
    if emb.requires_grad and torch.is_grad_enabled():
        raise RuntimeError(
            "fm_interaction: the CUDA kernel has no backward yet; call it "
            "under torch.inference_mode() or torch.no_grad()")
    out = torch.empty(b, dtype=torch.float32, device=emb.device)
    if b == 0:
        return out
    err = _lib()(emb.data_ptr(), b, f, d, out.data_ptr(),
                 common.stream_ptr(emb.device))
    common.check_launch(err, NAME)
    return out
