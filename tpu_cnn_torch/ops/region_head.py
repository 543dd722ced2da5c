"""The region head of the YOLOv2 detectors (``models.region``): decode,
threshold, per-class NMS and the best ``max_det`` (box, class) pairs.

``region_detect`` takes the last layer's int32 sums (B, A*(5+C), g, g) on
the device (on a card in channels-last memory: the streamed kernel's
output as it is) and returns ``dets`` (B, max_det, 6) float32 (x, y, w, h, score,
class; zero past the count) and ``count`` (B,) int32. On a CUDA tensor it
launches ``csrc/region_head.cu`` once a batch (its note says what it
computes); on a CPU tensor it runs ``region_detect_reference``, the same
float32 arithmetic in plain torch. Any other device, or a geometry the
kernel does not take, raises: nothing falls back.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from tpu_cnn_torch.ops import _build

# kernel launches made by this wrapper in this process
launches = 0


def _iou(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """darknet's ``box_iou`` of (..., 4) (x, y, w, h) boxes, broadcast."""
    def overlap(c1, w1, c2, w2):
        return (torch.minimum(c1 + w1 / 2, c2 + w2 / 2)
                - torch.maximum(c1 - w1 / 2, c2 - w2 / 2))

    ow = overlap(a[..., 0], a[..., 2], b[..., 0], b[..., 2])
    oh = overlap(a[..., 1], a[..., 3], b[..., 1], b[..., 3])
    inter = torch.where((ow < 0) | (oh < 0), torch.zeros_like(ow), ow * oh)
    return inter / (a[..., 2] * a[..., 3] + b[..., 2] * b[..., 3] - inter)


def decode_reference(t: torch.Tensor, shift: int, anchors: torch.Tensor,
                     classes: int, thresh: float):
    """(B, A*(5+C), g, g) int32 -> boxes (B, N, 4) and thresholded scores
    (B, N, C) float32, N = A g^2 in darknet's order (n g^2 + i g + j)."""
    b, _, g, _ = t.shape
    a = anchors.shape[0]
    v = (t.to(torch.float32) * 2.0 ** -int(shift)).reshape(b, a, 5 + classes, g * g)
    v = v.permute(0, 1, 3, 2).reshape(b, a * g * g, 5 + classes)
    idx = torch.arange(g * g, device=t.device)
    col = (idx % g).to(torch.float32).repeat(a)
    row = (idx // g).to(torch.float32).repeat(a)
    anc = anchors.to(torch.float32).repeat_interleave(g * g, dim=0)
    boxes = torch.stack([(col + torch.sigmoid(v[..., 0])) / g,
                         (row + torch.sigmoid(v[..., 1])) / g,
                         anc[:, 0] * torch.exp(v[..., 2]) / g,
                         anc[:, 1] * torch.exp(v[..., 3]) / g], dim=-1)
    c = v[..., 5:]
    e = torch.exp(c - c.amax(dim=-1, keepdim=True))
    scores = torch.sigmoid(v[..., 4:5]) * (e / e.sum(dim=-1, keepdim=True))
    return boxes, torch.where(scores > thresh, scores, torch.zeros_like(scores))


def nms_reference(boxes: torch.Tensor, scores: torch.Tensor, nms: float,
                  frames_a_step: int = 8) -> torch.Tensor:
    """darknet's ``do_nms_sort`` on (B, N, 4) boxes and (B, N, C)
    thresholded scores (0: no candidate): per frame and class the
    candidates in order of score (ties by index), each kept one zeroing
    every later one whose IoU with it exceeds ``nms``, one step a
    candidate over every frame and class of ``frames_a_step`` frames at
    once -> the scores left (B, N, C)."""
    b, n, c = scores.shape
    kept = torch.zeros_like(scores)
    for lo in range(0, b, frames_a_step):
        bx, sc = boxes[lo:lo + frames_a_step], scores[lo:lo + frames_a_step]
        f = sc.shape[0]
        rows = sc.permute(0, 2, 1).reshape(f * c, n)
        order = torch.sort(-rows, dim=1, stable=True).indices
        width = max(int((rows > 0).sum(dim=1).max()), 1)
        order = order[:, :width]
        alive = torch.gather(rows, 1, order) > 0
        sel = torch.gather(bx[:, None].expand(f, c, n, 4).reshape(f * c, n, 4), 1,
                           order[..., None].expand(-1, -1, 4))
        over = _iou(sel[:, :, None], sel[:, None, :]) > nms
        for i in range(width - 1):
            alive[:, i + 1:] &= ~(alive[:, i:i + 1] & over[:, i, i + 1:])
        left = torch.zeros_like(rows).scatter_(
            1, order, torch.where(alive, torch.gather(rows, 1, order),
                                  torch.zeros_like(alive, dtype=rows.dtype)))
        kept[lo:lo + f] = left.reshape(f, c, n).permute(0, 2, 1)
    return kept


def top_reference(boxes: torch.Tensor, kept: torch.Tensor, max_det: int):
    """(B, N, 4) boxes and (B, N, C) scores left by NMS -> the ``max_det``
    best pairs in order of score (ties by index, then class): dets (B,
    max_det, 6) (zero past the count) and count (B,) int32."""
    b, n, c = kept.shape
    flat = kept.reshape(b, n * c)  # pair = index * C + class: ties in order
    order = torch.sort(-flat, dim=1, stable=True).indices[:, :max_det]
    top = torch.gather(flat, 1, order)
    count = (top > 0).sum(dim=1).to(torch.int32)
    dets = torch.cat([torch.gather(boxes, 1, (order // c)[..., None].expand(-1, -1, 4)),
                      top[..., None], (order % c).to(kept.dtype)[..., None]], dim=-1)
    dets = dets * (top > 0)[..., None]
    if dets.shape[1] < max_det:
        dets = torch.nn.functional.pad(dets, (0, 0, 0, max_det - dets.shape[1]))
    return dets, count


def region_detect_reference(t: torch.Tensor, shifts: torch.Tensor, layer: int,
                            anchors: torch.Tensor, classes: int, thresh: float,
                            nms: float, max_det: int):
    """The plain version, in float32: ``decode_reference``,
    ``nms_reference``, ``top_reference`` -> (dets, count)."""
    boxes, scores = decode_reference(t, int(shifts[layer]), anchors, classes, thresh)
    return top_reference(boxes, nms_reference(boxes, scores, nms), max_det)


@functools.lru_cache(maxsize=None)
def _lib() -> ctypes.CDLL:
    lib = _build.load("region_head")
    p, i, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    lib.region_head_forward.argtypes = [p, p, i, p, p, p, i, i, i, i, f, f, i, i, p]
    lib.region_head_forward.restype = i
    lib.region_head_smem_bytes.argtypes = [i, i, i]
    lib.region_head_smem_bytes.restype = ctypes.c_longlong
    lib.region_head_error_string.argtypes = [i]
    lib.region_head_error_string.restype = ctypes.c_char_p
    return lib


def region_detect(t: torch.Tensor, shifts: torch.Tensor, layer: int,
                  anchors: torch.Tensor, classes: int, thresh: float, nms: float,
                  max_det: int):
    """(B, A*(5+C), g, g) int32 sums of the last layer, the shift vector
    read at ``layer``, (A, 2) float32 anchors -> dets (B, max_det, 6)
    float32, count (B,) int32 (the module docstring)."""
    global launches
    if t.dtype != torch.int32 or t.dim() != 4 or t.shape[2] != t.shape[3]:
        raise ValueError(f"t must be (B, A*(5+C), g, g) int32, got "
                         f"{tuple(t.shape)} {t.dtype}")
    a = anchors.shape[0]
    if anchors.dtype != torch.float32 or tuple(anchors.shape) != (a, 2) or \
            t.shape[1] != a * (5 + classes):
        raise ValueError(f"{t.shape[1]} channels are not {a} anchors x (5 + "
                         f"{classes}) (anchors (A, 2) float32)")
    if max_det < 1:
        raise ValueError(f"max_det {max_det}: need at least 1")
    if t.device.type == "cpu":
        return region_detect_reference(t, shifts, layer, anchors, classes, thresh,
                                       nms, max_det)
    if t.device.type != "cuda":
        raise ValueError(f"the region head runs on CUDA tensors (the kernel) or "
                         f"CPU tensors (its plain version), not on {t.device}")
    if any(x.device != t.device for x in (shifts, anchors)):
        raise ValueError("t, shifts and anchors must be on one device")
    b, _, g, _ = t.shape
    tl = t.permute(0, 2, 3, 1)
    if not tl.is_contiguous():
        raise ValueError("t must be in channels-last memory (the streamed "
                         "kernel's output)")
    lib = _lib()
    if lib.region_head_smem_bytes(g, a, classes) <= 0:
        raise ValueError(f"the region head kernel does not take a {g}x{g} grid of "
                         f"{a} anchors and {classes} classes")
    dets = torch.empty((b, max_det, 6), dtype=torch.float32, device=t.device)
    count = torch.empty(b, dtype=torch.int32, device=t.device)
    dev = t.device
    err = lib.region_head_forward(
        tl.data_ptr(), shifts.data_ptr(), layer, anchors.data_ptr(), dets.data_ptr(),
        count.data_ptr(), b, g, a, classes, thresh, nms, max_det,
        dev.index if dev.index is not None else torch.cuda.current_device(),
        torch.cuda.current_stream(dev).cuda_stream)
    if err != 0:
        raise RuntimeError(f"region_head_forward failed: cudaError {err} "
                           f"({lib.region_head_error_string(err).decode()})")
    launches += 1
    return dets, count
