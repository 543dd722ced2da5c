"""The single-box CAM head in one kernel launch: wrapper and plain version.

``detect_pooled_fused`` is the head of the fused detect on the
megakernel's outputs (the bins and the bf16 twin of the features) with the
reference threshold box: the classifier, its softmax, the CAM of the
predicted class, the percentile-70 threshold and the box. On CUDA tensors
it launches ``csrc/cam_head.cu`` once a batch; on CPU tensors it runs the
plain version, which is ``detect_head.detect_with_pooled`` with
``box_mode="ref"`` itself. Any other device, or a geometry the kernel
does not take on CUDA, raises: nothing falls back.

The kernel replaces no TPU kernel: the JAX package's head
(``tpu_cnn.ops.detect_head``) is XLA ops, and the port ran it as about 50
aten launches a batch. What bounds it on the card is the twin's bytes
(C * P * 2 an image, 32 KB on lyr3-std), read once from HBM; its design
(the kernel's header) is one CTA an image that brings the image into
shared memory with bulk copies and does every step there, so the bins, the
CAM, the order statistics and the box never travel through HBM.

While a ``torch.profiler`` profile runs, the launch is the span
``head.cam`` and the counter ``head.fused.frames`` adds the batch the
kernel served (``utils.profiling``); the plain version keeps its own
spans and counts nothing.
"""

from __future__ import annotations

import ctypes
import functools
import math

import torch

from tpu_cnn_torch.ops import _build, detect_head
from tpu_cnn_torch.utils.profiling import count, span

# kernel launches made by this wrapper in this process
launches = 0


def percentile_order(pixels: int, q_pct: float = detect_head.CAM_PERCENTILE):
    """(lo, hi, frac): the two ascending order statistics of ``pixels``
    values that the percentile interpolates between, and the fraction, as
    ``detect_head._percentile_topk`` computes them on the host."""
    q = q_pct / 100.0 * (pixels - 1)
    lo, hi = math.floor(q), math.ceil(q)
    return lo, hi, q - lo


@functools.lru_cache(maxsize=None)
def _lib() -> ctypes.CDLL:
    lib = _build.load("cam_head")
    p, i = ctypes.c_void_p, ctypes.c_int
    lib.cam_head_forward.argtypes = [p] * 8 + [i] * 7 + [ctypes.c_float, i, p]
    lib.cam_head_forward.restype = i
    lib.cam_head_smem_bytes.argtypes = [i, i, i]
    lib.cam_head_smem_bytes.restype = i
    lib.cam_head_error_string.argtypes = [i]
    lib.cam_head_error_string.restype = ctypes.c_char_p
    return lib


def _check(pooled, twin, fc_weight, fc_bias):
    if twin.dtype != torch.bfloat16 or twin.dim() != 3:
        raise ValueError(f"twin must be (B, C, P) bfloat16, got "
                         f"{tuple(twin.shape)} {twin.dtype}")
    b, c, p = twin.shape
    k = fc_weight.shape[0]
    want = {"pooled": (pooled, (b, 16 * c)), "fc_weight": (fc_weight, (k, 16 * c)),
            "fc_bias": (fc_bias, (k,))}
    for name, (t, shape) in want.items():
        if t.dtype != torch.float32 or tuple(t.shape) != shape:
            raise ValueError(f"{name} must be {shape} float32 for a twin of "
                             f"{tuple(twin.shape)}, got {tuple(t.shape)} {t.dtype}")
    tensors = (pooled, twin, fc_weight, fc_bias)
    if any(t.device != twin.device for t in tensors):
        raise ValueError("pooled, twin, fc_weight and fc_bias must be on one "
                         "device")
    if not all(t.is_contiguous() for t in tensors):
        raise ValueError("pooled, twin, fc_weight and fc_bias must be "
                         "contiguous")
    if twin.device.type not in ("cpu", "cuda"):
        raise ValueError(f"detect_pooled_fused runs on CUDA tensors (the "
                         f"kernel) or CPU tensors (its plain version), not "
                         f"on {twin.device}")


def _launch(pooled, twin, fc_weight, fc_bias, img_size):
    """The kernel on the tensors' CUDA device and current stream."""
    global launches
    dev = twin.device
    b, c, p = twin.shape
    k = fc_weight.shape[0]
    if any(t.data_ptr() % 16 for t in (pooled, twin, fc_weight)):
        raise ValueError("pooled, twin and fc_weight must start 16-byte "
                         "aligned: the kernel's bulk copies and vector loads "
                         "read them")
    pred = torch.empty((b,), dtype=torch.int32, device=dev)
    conf = torch.empty((b,), dtype=torch.float32, device=dev)
    probs = torch.empty((b, k), dtype=torch.float32, device=dev)
    bbox = torch.empty((b, 4), dtype=torch.int32, device=dev)
    lo, hi, frac = percentile_order(p)
    lib = _lib()
    err = lib.cam_head_forward(
        pooled.data_ptr(), twin.data_ptr(), fc_weight.data_ptr(),
        fc_bias.data_ptr(), pred.data_ptr(), conf.data_ptr(), probs.data_ptr(),
        bbox.data_ptr(), b, c, p, k, img_size, lo, hi, frac,
        dev.index if dev.index is not None else torch.cuda.current_device(),
        torch.cuda.current_stream(dev).cuda_stream)
    if err == 1 and not lib.cam_head_smem_bytes(c, p, k):  # cudaErrorInvalidValue
        raise ValueError(f"the CAM head kernel does not take C={c}, P={p}, "
                         f"K={k}: P must be a power-of-two side squared, "
                         f"4 <= side <= 32, within one CTA's shared memory")
    if err == 1 and (img_size < math.isqrt(p) or img_size % math.isqrt(p)):
        raise ValueError(f"img_size {img_size} must be a multiple of the "
                         f"CAM's side {math.isqrt(p)}")
    if err != 0:
        raise RuntimeError(f"cam_head_forward failed: cudaError {err} "
                           f"({lib.cam_head_error_string(err).decode()})")
    launches += 1
    return pred, conf, probs, bbox


def detect_pooled_fused(pooled: torch.Tensor, twin: torch.Tensor,
                        fc_weight: torch.Tensor, fc_bias: torch.Tensor,
                        img_size: int):
    """(pred (B,) int32, conf (B,) f32, probs (B, K) f32, bbox (B, 4)
    int32) from the bins (B, 16C) f32 and the bf16 twin (B, C, P) of the
    features, with the classifier's (K, 16C) weights and (K,) bias: what
    ``detect_head.detect_with_pooled(None, pooled, fc_weight, fc_bias,
    img_size, features_twin=twin, box_mode="ref")`` returns. One kernel
    launch on CUDA tensors, that function on CPU tensors."""
    _check(pooled, twin, fc_weight, fc_bias)
    if twin.device.type == "cpu":
        return detect_head.detect_with_pooled(
            None, pooled, fc_weight, fc_bias, img_size, features_twin=twin,
            box_mode="ref")
    with span("head.cam"):
        out = _launch(pooled, twin, fc_weight, fc_bias, img_size)
    count("head.fused.frames", twin.shape[0])
    return out
