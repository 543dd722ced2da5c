"""Environment + artifact self-check — first-line triage for deployments:
the port's ``tpu_cnn.apps.doctor``.

The reference's analogue is scattered: the PYNQ overlay probe and
``wait_done`` stuck-layer diagnostics (``pynq_inference.py:236-251``) and
the camera watchdog. This CLI concentrates the checks a production host
needs BEFORE serving traffic:

  1. runtime: platform ``gpu``, ``torch.cuda.device_count()``, the card's
     name and compute capability (with ``--host-only`` a machine without
     a card passes, as platform ``cpu``);
  2. artifacts: every shipped bundle loads (codec, head shapes, shifts);
  3. numerics: the host oracles agree bit-for-bit on a stimulus batch
     (numpy vs native C++ — catches a broken toolchain/build);
  4. device (when not --host-only): a tiny tensor round trip on the card
     with a bounded wait, reporting its latency — catches a wedged CUDA
     context or device without hanging.

Exit code 0 = all checks pass; 1 = something needs attention.

Usage:
  python -m tpu_cnn_torch.apps.doctor [--host-only] [--artifacts DIR ...]
"""

from __future__ import annotations

import argparse
import os
import time

import numpy as np

_DEFAULT_BUNDLES = (
    ("artifacts/pretrained", "lyr3-std"),
    ("artifacts/pretrained-lyr2", "lyr2-small"),
    ("artifacts/pretrained-lyr4", "lyr4-wide"),
    ("artifacts/realphoto/bundle-qat", "lyr3-std"),
)


def _bounded(fn, timeout: float):
    """Run ``fn`` on a DAEMON thread with a deadline: a wedged device
    blocks CUDA calls (first-touch context creation included)
    indefinitely, and a non-daemon worker would then also block
    interpreter exit — triage must terminate either way."""
    import threading as _t

    out: dict = {}

    def run():
        try:
            out["value"] = fn()
        except Exception as e:  # noqa: BLE001 — surfaced to the caller
            out["error"] = e

    th = _t.Thread(target=run, daemon=True)
    th.start()
    th.join(timeout)
    if th.is_alive():
        raise TimeoutError(
            f"did not complete in {timeout:.0f}s — CUDA context wedged or "
            "device unreachable"
        )
    if "error" in out:
        raise out["error"]
    return out.get("value")


def _check(name: str, fn, failures: list) -> None:
    t0 = time.perf_counter()
    try:
        detail = fn()
        dt = (time.perf_counter() - t0) * 1e3
        print(f"  [ok]   {name:34s} {detail or ''}  ({dt:.0f} ms)")
    except Exception as e:  # noqa: BLE001 — triage tool reports, not raises
        failures.append(name)
        print(f"  [FAIL] {name:34s} {type(e).__name__}: {e}")


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description="tpu_cnn_torch environment doctor")
    p.add_argument("--host-only", action="store_true",
                   help="skip the device dispatch check (no card contact)")
    p.add_argument("--artifacts", action="append", default=None,
                   metavar="DIR[:VARIANT]",
                   help="bundle dir(s) to audit (default: every shipped "
                        "bundle present in the repo)")
    p.add_argument("--device-timeout", type=float, default=60.0,
                   help="seconds to wait for the tiny device dispatch "
                        "before declaring the device wedged")
    args = p.parse_args(argv)
    failures: list = []

    print("=" * 64)
    print("  TPU CNN DOCTOR (PyTorch/CUDA port)")
    print("=" * 64)

    # 1. runtime — bounded: the first CUDA query creates the context,
    # itself a device touch that can wedge
    def runtime():
        def probe():
            import torch

            if not torch.cuda.is_available():
                if args.host_only:
                    return "platform=cpu devices=0 (no CUDA device; host only)"
                raise RuntimeError("torch finds no CUDA device")
            n = torch.cuda.device_count()
            major, minor = torch.cuda.get_device_capability(0)
            return (f"platform=gpu devices={n} "
                    f"card={torch.cuda.get_device_name(0)} "
                    f"sm_{major}{minor} torch={torch.__version__} "
                    f"cuda={torch.version.cuda}")

        return _bounded(probe, args.device_timeout)

    _check("runtime", runtime, failures)
    runtime_ok = not failures

    # 2. artifacts
    from tpu_cnn_torch.utils.paths import _REPO_ROOT

    if args.artifacts:
        bundles = []
        for spec in args.artifacts:
            d, _, v = spec.partition(":")
            bundles.append((d, v or "lyr3-std"))
    else:
        bundles = [(os.path.join(_REPO_ROOT, d), v) for d, v in _DEFAULT_BUNDLES
                   if os.path.isdir(os.path.join(_REPO_ROOT, d))]

    from tpu_cnn_torch.apps.common import load_model

    for d, variant in bundles:
        def audit(d=d, variant=variant):
            m = load_model(d, variant)
            return (f"{variant} head{tuple(m.fc_weight.shape)} "
                    f"shifts={list(map(int, m.shifts))}")

        _check(f"bundle {os.path.basename(d) or d}", audit, failures)

    # 3. host numerics: the two independent oracles must agree exactly
    def oracles():
        from tpu_cnn_torch.engine.cpu_ref import CPURefEngine
        from tpu_cnn_torch.models.cnn import LAYER_CONFIGS

        rs = np.random.RandomState(0)
        kernels = [rs.randint(-128, 128, (oc, ic, 3, 3)).astype(np.int8)
                   for ic, oc, _ in LAYER_CONFIGS]
        imgs = rs.randint(0, 256, (2, 128, 128)).astype(np.uint8)
        a = CPURefEngine(kernels, use_native=False).run_batch(imgs)
        native = CPURefEngine(kernels, use_native=True)
        if native.backend != "native-c++":
            return "numpy ok (native oracle unavailable — skipped)"
        b = native.run_batch(imgs)
        np.testing.assert_array_equal(a, b)
        return "numpy == native C++ (bit-exact)"

    _check("host oracles", oracles, failures)

    # 4. device round trip (bounded — a wedged device must not hang triage)
    if not args.host_only:
        def device():
            def tiny():
                import torch

                t0 = time.perf_counter()
                x = torch.from_numpy(np.ones((8, 8), np.float32)).to("cuda")
                v = float(x.sum().cpu())
                if v != 64.0:
                    raise RuntimeError(f"ones((8, 8)).sum() gave {v} on the card")
                ms = (time.perf_counter() - t0) * 1e3
                return (f"{torch.cuda.get_device_name(0)} round-trip "
                        f"{ms:.1f} ms")

            return _bounded(tiny, args.device_timeout)

        if runtime_ok:
            _check("device dispatch", device, failures)
        else:
            print("  [skip] device dispatch                 "
                  "(runtime probe already failed)")

    print("-" * 64)
    if failures:
        print(f"  {len(failures)} check(s) FAILED: {', '.join(failures)}")
        return 1
    print("  all checks passed")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
