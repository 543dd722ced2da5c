"""The bitcast/roll probe on the port's kernel.

Port of ``scripts/probe_bitcast.py``: the same three questions, on the
same seeded inputs, answered by ``tpu_cnn_torch.ops.bitcast`` on
``--device`` (``cuda``: the hand-written kernel ``csrc/bitcast.cu``;
``cpu``: its plain version):

  Q1: narrow (R, L) int32 -> int8: the resulting shape, and which byte of
      each word lands in which row;
  Q2: widen (4R, L) u8 -> int32: the inverse packing;
  Q3: an int32 lane roll moves the 4 packed bytes of a word together.

Each layout line says MATCH or no. The layouts this program expects are
the ones the TPU showed (docs/DESIGN.md, "Mosaic constraints" 7): row
4r+b holds byte b of word row r, for the narrow and the widen alike.
Unlike the TPU script, it exits 1 as soon as an expected layout does not
match or a launch raises, and 2 when ``--device cuda`` finds no card.

Usage:
  python -m tpu_cnn_torch.apps.probe_bitcast --device cuda
  python -m tpu_cnn_torch.apps.probe_bitcast --device cpu
"""

from __future__ import annotations

import argparse
import sys

import numpy as np
import torch

from tpu_cnn_torch.ops import bitcast

R, L = 8, 256
EXPECTED = "r*4+b"


def _layout_lines(matches: dict[str, bool]) -> bool:
    for layout, ok in matches.items():
        print(f"  layout {layout}: {'MATCH' if ok else 'no'}")
    return matches[next(k for k in matches if k.startswith(EXPECTED))]


def _ask(question: str, fn):
    """Run one question's launch; a raise prints the FAILED line and
    returns None."""
    try:
        out = fn()
        if out.is_cuda:
            torch.cuda.synchronize(out.device)
        return out.cpu().numpy()
    except (RuntimeError, ValueError, OSError) as e:
        print(f"{question} FAILED: {type(e).__name__} {str(e)[:300]}")
        return None


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description="width-changing bitcast and "
                                            "packed-roll probe on the port")
    p.add_argument("--device", default="cuda", choices=["cuda", "cpu"],
                   help="cuda launches the hand-written kernel; cpu runs its "
                        "plain PyTorch version")
    args = p.parse_args(argv)
    if args.device == "cuda" and not torch.cuda.is_available():
        print("probe_bitcast: --device cuda but torch finds no CUDA device")
        return 2
    dev = torch.device(args.device)
    name = torch.cuda.get_device_name(dev) if dev.type == "cuda" else "cpu"
    print(f"platform: {args.device} ({name})")
    rs = np.random.RandomState(0)

    # Q1: narrow i32 -> i8
    x = rs.randint(-2**31, 2**31, size=(R, L)).astype(np.int32)
    xt = torch.from_numpy(x).to(dev)
    y = _ask("Q1 narrow", lambda: bitcast.narrow_i32_to_i8(xt))
    if y is None:
        return 1
    print("Q1 narrow OK, shape", y.shape)
    bytes_le = x.view(np.uint8).reshape(R, L, 4)  # (r, l, byte)
    ok = _layout_lines({
        layout: y.shape == (4 * R, L) and all(
            np.array_equal(got(r, b), bytes_le[r, :, b])
            for r in range(R) for b in range(4))
        for layout, got in (
            ("r*4+b (word-major rows)", lambda r, b: y[r * 4 + b].astype(np.uint8)),
            ("b*R+r (byte-plane rows)", lambda r, b: y[b * R + r].astype(np.uint8)),
        )})
    if not ok:
        return 1

    # Q2: widen u8 -> i32
    x8 = rs.randint(0, 256, size=(4 * R, L)).astype(np.uint8)
    x8t = torch.from_numpy(x8).to(dev)
    y = _ask("Q2 widen", lambda: bitcast.widen_u8_to_i32(x8t))
    if y is None:
        return 1
    print("Q2 widen OK, shape", y.shape)
    matches = {}
    for layout, src in (("r*4+b", lambda r, b: x8[r * 4 + b]),
                        ("b*R+r", lambda r, b: x8[b * R + r])):
        want = np.zeros((R, L), np.uint32)
        for r in range(R):
            for b in range(4):
                want[r] |= src(r, b).astype(np.uint32) << (8 * b)
        matches[layout] = y.shape == (R, L) and np.array_equal(y.view(np.uint32), want)
    if not _layout_lines(matches):
        return 1

    # Q3: packed roll
    y = _ask("Q3", lambda: bitcast.packed_roll(xt, 3))
    if y is None:
        return 1
    ok = np.array_equal(y, np.roll(x, 3, axis=1))
    print("Q3 packed i32 roll:", "MATCH" if ok else "MISMATCH")
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
