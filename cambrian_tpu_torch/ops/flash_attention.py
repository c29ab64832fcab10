"""Fused masked attention forward: kernel K1 of the port.

``flash_attention`` launches the hand-written CUDA kernel in
``csrc/flash_attention.cu`` for CUDA tensors and uses the plain PyTorch
version, ``flash_attention_reference``, for CPU tensors. The kernel replaces
the TPU kernel ``cambrian_tpu/ops/flash_attention.py::_attn_kernel``; the
plain version has the semantics of that module's ``_xla_reference``.

The kernel is compiled with ``nvcc`` for sm_90a on first use
(``ops/cuda_build.py``) and loaded with ctypes. Nothing is compiled or
loaded at import time.
"""

import ctypes
import functools
from typing import Optional

import torch

from . import cuda_build
from .attention import NEG_INF

MAX_HEAD_DIM = 128
_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}


def flash_attention_reference(q, k, v, key_valid=None, causal=False,
                              sliding_window=None, q_offset=0, scale=None):
    """Plain PyTorch attention with the kernel's mask semantics.

    q [B, Sq, H, D], k/v [B, Sk, KVH, D] (H a multiple of KVH), key_valid
    [B, Sk] bool. Logits and softmax in fp32; a row with no surviving key is
    0. Returns [B, Sq, H, D] in q.dtype.
    """
    b, s_q, h, d = q.shape
    s_k, kvh = k.shape[1], k.shape[2]
    if scale is None:
        scale = d ** -0.5
    if kvh != h:
        k = k.repeat_interleave(h // kvh, dim=2)
        v = v.repeat_interleave(h // kvh, dim=2)
    logits = torch.einsum("bqhd,bkhd->bhqk", q.float(), k.float()) * scale
    if key_valid is None:
        mask = torch.ones((b, 1, 1, s_k), dtype=torch.bool, device=q.device)
    else:
        mask = key_valid.to(torch.bool)[:, None, None, :]
    if causal or sliding_window is not None:
        q_pos = q_offset + torch.arange(s_q, device=q.device)[:, None]
        k_pos = torch.arange(s_k, device=q.device)[None, :]
        if causal:
            mask = mask & (k_pos <= q_pos)
        if sliding_window is not None:
            mask = mask & ((q_pos - k_pos) < sliding_window)
    logits = torch.where(mask, logits, NEG_INF)
    probs = torch.softmax(logits, dim=-1)
    probs = torch.where(mask, probs, 0.0)
    return torch.einsum("bhqk,bkhd->bqhd", probs.to(q.dtype), v.to(q.dtype))


@functools.lru_cache(maxsize=None)
def _library() -> ctypes.CDLL:
    lib = ctypes.CDLL(cuda_build.build("flash_attention")["flash_attention"]["path"])
    i64, i32, ptr = ctypes.c_int64, ctypes.c_int, ctypes.c_void_p
    lib.cambrian_flash_attention_fwd.argtypes = (
        [i32] + [ptr] * 5 + [i64] * 12 + [i32] * 6
        + [ctypes.c_float, i32, i32, i32, ptr])
    lib.cambrian_flash_attention_fwd.restype = i32
    lib.cambrian_cuda_error_string.argtypes = [i32]
    lib.cambrian_cuda_error_string.restype = ctypes.c_char_p
    return lib


def _check_inputs(q, k, v, key_valid):
    b, s_q, h, d = q.shape
    if k.dim() != 4 or k.shape != v.shape or k.shape[0] != b or k.shape[3] != d:
        raise ValueError(f"k/v must be [B, Sk, KVH, D] matching q {tuple(q.shape)}, "
                         f"got {tuple(k.shape)} and {tuple(v.shape)}")
    if h % k.shape[2] != 0:
        raise ValueError(f"{h} heads are not a multiple of {k.shape[2]} kv heads")
    if q.dtype not in _DTYPE_CODES or k.dtype != q.dtype or v.dtype != q.dtype:
        raise TypeError(f"kernel takes float32 or bfloat16 q/k/v of one dtype, "
                        f"got {q.dtype}, {k.dtype}, {v.dtype}")
    if d > MAX_HEAD_DIM:
        raise ValueError(f"kernel takes head_dim <= {MAX_HEAD_DIM}, got {d}")
    for name, t in (("q", q), ("k", k), ("v", v)):
        if t.device != q.device:
            raise ValueError(f"{name} is on {t.device}, q on {q.device}")
        if t.stride(-1) != 1:
            raise ValueError(f"{name} must have a unit stride on head_dim")
    if key_valid is not None and tuple(key_valid.shape) != (b, k.shape[1]):
        raise ValueError(f"key_valid must be [B, Sk] = {(b, k.shape[1])}, "
                         f"got {tuple(key_valid.shape)}")


def flash_attention(
    q: torch.Tensor,                          # [B, Sq, H, D]
    k: torch.Tensor,                          # [B, Sk, KVH, D]
    v: torch.Tensor,                          # [B, Sk, KVH, D]
    key_valid: Optional[torch.Tensor] = None,  # [B, Sk] bool
    causal: bool = False,
    sliding_window: Optional[int] = None,
    q_offset: int = 0,
    scale: Optional[float] = None,
) -> torch.Tensor:
    """Masked attention in BQHD layout with GQA read in place.

    CPU tensors go to ``flash_attention_reference``. CUDA tensors launch the
    kernel (``flash_attention.launches`` counts the launches) or raise; there
    is no fallback to the plain version on the card.
    """
    if q.device.type == "cpu":
        return flash_attention_reference(q, k, v, key_valid, causal,
                                         sliding_window, q_offset, scale)
    if q.device.type != "cuda":
        raise ValueError(f"flash_attention runs on cpu or cuda, not {q.device}")
    _check_inputs(q, k, v, key_valid)
    if sliding_window is not None and sliding_window < 1:
        raise ValueError(f"sliding_window must be >= 1, got {sliding_window}")
    b, s_q, h, d = q.shape
    s_k, kvh = k.shape[1], k.shape[2]
    if scale is None:
        scale = d ** -0.5
    valid = None
    if key_valid is not None:
        valid = key_valid.to(device=q.device, dtype=torch.bool).contiguous()
    out = torch.empty((b, s_q, h, d), dtype=q.dtype, device=q.device)
    lib = _library()
    stream = torch.cuda.current_stream(q.device).cuda_stream
    flash_attention.launches += 1
    err = lib.cambrian_flash_attention_fwd(
        _DTYPE_CODES[q.dtype], q.data_ptr(), k.data_ptr(), v.data_ptr(),
        None if valid is None else valid.data_ptr(), out.data_ptr(),
        q.stride(0), q.stride(1), q.stride(2),
        k.stride(0), k.stride(1), k.stride(2),
        v.stride(0), v.stride(1), v.stride(2),
        out.stride(0), out.stride(1), out.stride(2),
        b, h, kvh, s_q, s_k, d, float(scale), int(bool(causal)),
        -1 if sliding_window is None else int(sliding_window), int(q_offset),
        stream)
    if err != 0:
        msg = lib.cambrian_cuda_error_string(err).decode()
        raise RuntimeError(f"flash_attention kernel launch failed: {msg}")
    return out


flash_attention.launches = 0
