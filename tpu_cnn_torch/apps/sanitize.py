"""The sanitizer lane: rebuild the port's native code instrumented, in a
directory of its own, drive it, and fail on any report.

    python -m tpu_cnn_torch.apps.sanitize asan      # the host library: overflows, use after free
    python -m tpu_cnn_torch.apps.sanitize tsan      # the host library: data races (ring, HTTP front)
    python -m tpu_cnn_torch.apps.sanitize memcheck racecheck synccheck initcheck   # the card

The counterpart of the JAX package's ``scripts/sanitize_native.sh``,
extended to the port's CUDA kernels.

``asan`` / ``tsan`` rebuild the host library ``tcnn_host`` (the C++
oracle and preprocess, the frame ring and the HTTP front) with
``-fsanitize=address`` or ``-fsanitize=thread`` into a fresh temporary
directory (``ops._build``'s ``TPU_CNN_TORCH_BUILD_DIR`` and
``TPU_CNN_TORCH_EXTRA_CXXFLAGS``), then run the port's tests marked
``native`` (the oracle against the numpy contract and the JAX package's
oracle, the native preprocess, the ring, the native front; no jitted JAX:
XLA does not run under a preloaded sanitizer runtime) in a child process
with the sanitizer's runtime preloaded (``g++ -print-file-name``). Extra
arguments name other tests (pytest node ids). A report, a failed test, no
test run or a child that died fails the tool.

``memcheck`` (out-of-bounds and misaligned accesses), ``racecheck``
(shared-memory hazards), ``synccheck`` (barrier misuse) and ``initcheck``
(reads of device memory never written) first run ``probe`` (one kernel
in PTX through the driver: seconds, no build) under NVIDIA's
``compute-sanitizer --tool <tool>``. A tool under which the probe's
kernel did not run is not measured: ``refused`` when compute-sanitizer
said the card is not supported ("Device not supported"), failed
otherwise. Then they rebuild the five kernels of ``csrc/`` with
``-lineinfo`` (``TPU_CNN_TORCH_EXTRA_NVCCFLAGS``) into a fresh temporary
directory and run ``apps.kernel_cases`` (phase 3 of ``chip_smoke.py``, at
full model widths) in a child under the tool, checking only the port's
kernels (their names are read from the sources, and each must be in its
built library) except under ``initcheck``, which must see torch's writes
of the inputs. The caching allocator is off under ``memcheck`` and
``initcheck`` (an overrun inside a cached block, or a read of a reused
one, would go unseen). The child must launch all five kernels and its
launches must take every path of ``kernel_cases.REQUIRED_PATHS``, as the
libraries counted them. Any report fails the tool. Under ``memcheck`` a
second child makes one deliberate out-of-bounds launch (``canary``: the
bitcast kernel's narrow with a row count past its buffers), which the
tool must report.

Per tool one line: what ran, the reports, the seconds and the verdict,
then with ``--json`` one JSON object per tool. Exit 0 when every tool
passed, 1 otherwise (a refused tool included). ``--timeout`` bounds the
whole run: each child gets the time that is left, and a tool whose turn
comes after it is spent fails unrun.
"""

from __future__ import annotations

import argparse
import ctypes
import dataclasses
import glob
import json
import os
import re
import shutil
import signal
import subprocess
import sys
import tempfile
import time

from tpu_cnn_torch.ops import _build

HOST_TOOLS = ("asan", "tsan")
CARD_TOOLS = ("memcheck", "racecheck", "synccheck", "initcheck")
KERNELS = ("mega_cnn", "conv_pool_layer", "conv_act", "bitcast", "cam_head", "region_layer")
REPO = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
# the port's tests that drive the host library, each file's ``native``
# tests selected by the marker
NATIVE_TEST_FILES = ("tests/test_torch_copies.py", "tests/test_torch_native_front.py",
                     "tests/test_torch_sanitize.py")
# the JAX lane's runtime options: LSan off (it would report the
# uninstrumented interpreter's own allocations), the first ASan error
# aborts at the faulting access; ctypes loads libraries after the runtime
HOST_OPTIONS = {
    "asan": ("ASAN_OPTIONS", "detect_leaks=0:abort_on_error=1:verify_asan_link_order=0"),
    "tsan": ("TSAN_OPTIONS", "halt_on_error=0:report_bugs=1"),
}
REPORT_RE = {"asan": re.compile(r"ERROR: AddressSanitizer"),
             "tsan": re.compile(r"WARNING: ThreadSanitizer")}
ERROR_EXITCODE = 86  # compute-sanitizer's exit code on a report
DEVICE_REFUSED = "Device not supported"
# the probe's kernel: writes 42 into one word (PTX, compiled by the driver)
PROBE_PTX = """.version 8.0
.target sm_90
.address_size 64
.visible .entry probe(.param .u64 out)
{
  .reg .b32 %r<2>;
  .reg .b64 %rd<3>;
  ld.param.u64 %rd1, [out];
  cvta.to.global.u64 %rd2, %rd1;
  mov.u32 %r1, 42;
  st.global.u32 [%rd2], %r1;
  ret;
}
"""
PROBE_RAN = "probe: the kernel ran"


@dataclasses.dataclass
class Result:
    """One tool's run: ``reports`` None when no summary was found."""
    tool: str
    ran: str
    reports: int | None
    seconds: float
    ok: bool
    detail: str
    launches: dict | None = None
    paths: list | None = None
    canary: bool | None = None
    refused: bool = False  # compute-sanitizer refused the card; nothing ran

    def line(self) -> str:
        reports = "no summary" if self.reports is None else f"{self.reports} reports"
        return (f"[sanitize] {self.tool}: {self.ran}; {reports}; "
                f"{self.seconds:.1f} s; {'PASS' if self.ok else 'FAIL'}: {self.detail}")


# ── reading a tool's output ──────────────────────────────────────────


def parse_pytest(text: str) -> tuple[int, int]:
    """(passed, failed + errors) from pytest's last summary line; (-1, -1)
    when there is none."""
    for line in reversed(text.splitlines()):
        if re.search(r"\b(passed|failed|error|errors|deselected|no tests ran)\b", line) \
                and re.search(r"\bin [\d.]+s\b", line):
            count = {k: int(n) for n, k in re.findall(
                r"(\d+) (passed|failed|errors?)\b", line)}
            return (count.get("passed", 0),
                    count.get("failed", 0) + count.get("error", 0) + count.get("errors", 0))
    return -1, -1


def parse_host(tool: str, text: str, returncode: int) -> tuple[int | None, bool, str]:
    """(reports, ok, detail) of an ``asan``/``tsan`` pytest child."""
    reports = len(REPORT_RE[tool].findall(text))
    passed, failed = parse_pytest(text)
    if returncode < 0:
        return reports, False, f"the child died (signal {-returncode})"
    if reports:
        return reports, False, f"{reports} {tool} reports"
    if passed < 0:
        return None, False, f"no pytest summary (exit {returncode})"
    if failed or returncode != 0:
        return reports, False, f"{failed} tests failed (exit {returncode})"
    if passed == 0:
        return reports, False, "no test ran"
    return reports, True, f"{passed} tests passed"


def parse_sanitizer(tool: str, text: str, returncode: int) -> tuple[int | None, bool, str]:
    """(reports, ok, detail) of a child under ``compute-sanitizer``: its
    summary line (``ERROR SUMMARY: N errors``, racecheck's ``RACECHECK
    SUMMARY: N hazards displayed``) counted as reports."""
    m = re.search(r"RACECHECK SUMMARY: (\d+) hazards? displayed" if tool == "racecheck"
                  else r"ERROR SUMMARY: (\d+) errors?", text)
    reports = int(m.group(1)) if m else None
    if DEVICE_REFUSED in text:
        return reports, False, f"compute-sanitizer refused the device ({DEVICE_REFUSED!r})"
    if returncode < 0:
        return reports, False, f"the child died (signal {-returncode})"
    if reports is None:
        return None, False, f"no {tool} summary (exit {returncode})"
    if reports:
        return reports, False, f"{reports} {tool} reports"
    if returncode != 0:
        return reports, False, f"the child failed (exit {returncode})"
    return reports, True, "clean"


# ── the host library under ASan / TSan ───────────────────────────────


def _host_env(tool: str, build_dir: str) -> dict:
    """The child's environment: the build variables, and the runtime's
    options with its reports written to ``<build_dir>/report.<pid>``
    (pytest's capture would swallow what a passing test's threads write
    to stderr)."""
    env = dict(os.environ)
    flag = "-fsanitize=address" if tool == "asan" else "-fsanitize=thread"
    env.update(TPU_CNN_TORCH_BUILD_DIR=build_dir,
               TPU_CNN_TORCH_EXTRA_CXXFLAGS=f"{flag} -g")
    var, opts = HOST_OPTIONS[tool]
    env[var] = f"{opts}:log_path={os.path.join(build_dir, 'report')}"
    if tool == "tsan":
        # libgomp is not built with TSan: the oracle's OpenMP barriers are
        # invisible to it, so every read after a parallel loop would be
        # reported. One OpenMP thread runs that loop on the caller's thread;
        # the ring's and the front's own threads stay checked.
        env["OMP_NUM_THREADS"] = "1"
    env.pop("TPU_CNN_EXTRA_CXXFLAGS", None)  # the JAX library stays as it is
    return env


def _runtime(tool: str) -> str:
    gxx = shutil.which("g++")
    if gxx is None:
        raise _build.KernelBuildError("g++ not found: the host lanes need it")
    lib = "libasan.so" if tool == "asan" else "libtsan.so"
    path = subprocess.run([gxx, f"-print-file-name={lib}"], capture_output=True,
                          text=True, check=True).stdout.strip()
    if not os.path.isabs(path) or not os.path.exists(path):
        raise _build.KernelBuildError(f"g++ has no {lib} (it printed {path!r})")
    return path


def _run(argv, env, timeout: float, cwd: str = REPO) -> tuple[str, int]:
    """The child's output (stdout then stderr) and exit code. The child
    leads a process group of its own; one cut by ``timeout`` is killed
    with all it started (compute-sanitizer's target among them) and reads
    as SIGKILL."""
    with subprocess.Popen(argv, env=env, cwd=cwd, stdout=subprocess.PIPE,
                          stderr=subprocess.PIPE, text=True,
                          start_new_session=True) as proc:
        try:
            out, err = proc.communicate(timeout=timeout)
            return out + err, proc.returncode
        except subprocess.TimeoutExpired:
            os.killpg(proc.pid, signal.SIGKILL)
            out, err = proc.communicate()
            return out + err + f"\n(killed after {timeout:.0f} s)", -signal.SIGKILL


def _left(deadline: float) -> float:
    """Seconds until ``deadline`` (``time.monotonic``), at least one."""
    return max(1.0, deadline - time.monotonic())


def host_lane(tool: str, tests=(), deadline: float = float("inf")) -> Result:
    """``tcnn_host`` built with ``-fsanitize`` and the ``native`` tests of
    ``NATIVE_TEST_FILES`` (or of ``tests``) run against it with the
    runtime preloaded, by ``deadline``."""
    t0 = time.perf_counter()
    tests = [*(tests or NATIVE_TEST_FILES), "-m", "native"]
    ran = f"tcnn_host -fsanitize={'address' if tool == 'asan' else 'thread'}, pytest {' '.join(tests)}"
    with tempfile.TemporaryDirectory(prefix=f"tcnn_{tool}_") as build_dir:
        env = _host_env(tool, build_dir)
        lib = _child_print("from tpu_cnn_torch.ops import _build; "
                           "print(_build.build_host())", env, deadline)
        marker = b"__asan_init" if tool == "asan" else b"__tsan_init"
        with open(lib, "rb") as f:
            if marker not in f.read():
                return Result(tool, ran, None, time.perf_counter() - t0, False,
                              f"{lib} is not instrumented (no {marker.decode()})")
        env["LD_PRELOAD"] = _runtime(tool)
        text, rc = _run([sys.executable, "-m", "pytest", "-q", "-p", "no:cacheprovider",
                         "-p", "no:randomly", *tests], env, _left(deadline))
        for log in sorted(glob.glob(os.path.join(build_dir, "report.*"))):
            with open(log, errors="replace") as f:
                text += f.read()
    reports, ok, detail = parse_host(tool, text, rc)
    if not ok:
        sys.stderr.write(text[-20000:])
    return Result(tool, ran, reports, time.perf_counter() - t0, ok, detail)


def _child_print(code: str, env: dict, deadline: float) -> str:
    """The last line ``code`` prints in a child under ``env`` (this
    process keeps its own build cache and environment)."""
    proc = subprocess.run([sys.executable, "-c", code], env=env, cwd=REPO,
                          capture_output=True, text=True, timeout=_left(deadline))
    if proc.returncode != 0:
        raise _build.KernelBuildError(f"the build failed:\n{proc.stderr}")
    return proc.stdout.strip().splitlines()[-1]


# ── the kernels under compute-sanitizer ──────────────────────────────


def compute_sanitizer() -> str:
    """The ``compute-sanitizer`` executable, looked for as ``_build`` looks
    for nvcc."""
    cands = [os.path.join(os.environ[v], "bin", "compute-sanitizer")
             for v in ("CUDA_HOME", "CUDA_PATH") if os.environ.get(v)]
    cands += [shutil.which("compute-sanitizer") or "",
              "/usr/local/cuda/bin/compute-sanitizer",
              "/usr/local/cuda/compute-sanitizer/compute-sanitizer"]
    for c in cands:
        if c and os.path.exists(c):
            return c
    raise _build.KernelBuildError(
        "compute-sanitizer not found (looked in $CUDA_HOME/bin, $CUDA_PATH/bin, "
        "PATH, /usr/local/cuda/bin and /usr/local/cuda/compute-sanitizer): the "
        "card lanes need the CUDA toolkit's sanitizer")


_GLOBAL = re.compile(rb"__global__\s+void\s+(?:__launch_bounds__\([^)]*\)\s*)?(\w+)\s*\(")


def kernel_functions(name: str) -> list[str]:
    """The ``__global__`` functions of ``csrc/<name>.cu`` and its headers."""
    return sorted({m.decode() for _p, text in _build.local_sources(
        os.path.join(_build.CSRC_DIR, name + ".cu")) for m in _GLOBAL.findall(text)})


def _card_env(build_dir: str) -> dict:
    env = dict(os.environ)
    env.update(TPU_CNN_TORCH_BUILD_DIR=build_dir,
               TPU_CNN_TORCH_EXTRA_NVCCFLAGS="-lineinfo")
    return env


def build_kernels(build_dir: str, deadline: float) -> dict[str, str]:
    """The five kernels built with ``-lineinfo`` into ``build_dir``, one
    nvcc each, all started together. Returns name -> library. Each
    library must hold the ``__global__`` functions its sources name, and
    its name must not be the clean build's."""
    clean = {k: _build.kernel_library(k) for k in KERNELS}
    libs = json.loads(_child_print(
        "import concurrent.futures as cf, json; from tpu_cnn_torch.ops import _build; "
        f"names = {list(KERNELS)!r}; pool = cf.ThreadPoolExecutor(len(names)); "
        "print(json.dumps(dict(zip(names, (r[0] for r in pool.map(_build.build, names))))))",
        _card_env(build_dir), deadline))
    for name, lib in libs.items():
        if os.path.basename(lib) == os.path.basename(clean[name]):
            raise _build.KernelBuildError(f"{lib} carries the clean build's name")
        with open(lib, "rb") as f:
            data = f.read()
        missing = [k for k in kernel_functions(name) if k.encode() not in data]
        if missing or not kernel_functions(name):
            raise _build.KernelBuildError(f"{lib} lacks the kernels {missing}")
    return libs


def sanitizer_argv(tool: str, log: str) -> list[str]:
    """``compute-sanitizer`` with the tool, its error exit code, its log
    file and, but under initcheck, a filter of the port's kernels."""
    argv = [compute_sanitizer(), "--tool", tool, "--error-exitcode", str(ERROR_EXITCODE),
            "--log-file", log, "--print-limit", "200"]
    if tool != "initcheck":
        for fn in sorted({f for k in KERNELS for f in kernel_functions(k)}):
            argv += ["--kernel-name", f"kns={fn}"]
    return argv


def probe() -> None:
    """One kernel through the CUDA driver (``PROBE_PTX``, no nvcc and no
    torch): for a child under compute-sanitizer, which must let it run.
    Prints ``PROBE_RAN``, or the first call that failed and exits 1."""
    c = ctypes
    cu = c.CDLL("libcuda.so.1")
    cu.cuMemAlloc_v2.argtypes = [c.c_void_p, c.c_size_t]
    cu.cuMemcpyDtoH_v2.argtypes = [c.c_void_p, c.c_uint64, c.c_size_t]
    cu.cuLaunchKernel.argtypes = [c.c_void_p] + [c.c_uint] * 7 + [c.c_void_p] * 3
    dev, ctx, mod, fn = c.c_int(), c.c_void_p(), c.c_void_p(), c.c_void_p()
    ptr, word = c.c_uint64(), c.c_uint32()
    params = (c.c_void_p * 1)(c.cast(c.byref(ptr), c.c_void_p))
    for call, *args in (("cuInit", 0), ("cuDeviceGet", c.byref(dev), 0),
                        ("cuDevicePrimaryCtxRetain", c.byref(ctx), dev),
                        ("cuCtxSetCurrent", ctx),
                        ("cuModuleLoadData", c.byref(mod), PROBE_PTX.encode()),
                        ("cuModuleGetFunction", c.byref(fn), mod, b"probe"),
                        ("cuMemAlloc_v2", c.byref(ptr), 4),
                        ("cuLaunchKernel", fn, 1, 1, 1, 1, 1, 1, 0, None, params, None),
                        ("cuCtxSynchronize",),
                        ("cuMemcpyDtoH_v2", c.byref(word), ptr, 4)):
        err = getattr(cu, call)(*args)
        if err:
            sys.exit(f"probe: {call} returned CUDA error {err}")
    if word.value != 42:
        sys.exit(f"probe: the kernel wrote {word.value}, not 42")
    print(PROBE_RAN, flush=True)


def canary() -> None:
    """One out-of-bounds launch: the bitcast kernel's narrow told of 4096
    rows of 64 words on buffers of 4 rows. Only for a child under
    memcheck, which must report it."""
    import torch

    from tpu_cnn_torch.ops import bitcast

    dev = torch.device("cuda", 0)
    x = torch.zeros((4, 64), dtype=torch.int32, device=dev)
    y = torch.empty((16, 64), dtype=torch.int8, device=dev)
    err = bitcast._lib().bitcast_narrow(x.data_ptr(), y.data_ptr(), 4096, 64, 0,
                                        torch.cuda.current_stream(dev).cuda_stream)
    torch.cuda.synchronize(dev)
    print(json.dumps({"canary_launch": err}), flush=True)


def _card_child(tool: str, child: list[str], build_dir: str,
                deadline: float) -> tuple[str, str, int]:
    """(the child's output, the tool's log, exit code) of ``child`` under
    ``compute-sanitizer --tool tool``."""
    env = _card_env(build_dir)
    if tool in ("memcheck", "initcheck"):
        env["PYTORCH_NO_CUDA_MEMORY_CACHING"] = "1"
    fd, log = tempfile.mkstemp(suffix=f".{tool}.log", dir=build_dir)
    os.close(fd)
    out, rc = _run(sanitizer_argv(tool, log) + child, env, _left(deadline))
    with open(log, errors="replace") as f:
        return out, f.read(), rc


def _child_report(out: str) -> dict | None:
    for line in reversed(out.splitlines()):
        if line.startswith("{") and '"launches"' in line:
            return json.loads(line)
    return None


def probe_tool(tool: str, build_dir: str, deadline: float) -> Result | None:
    """``probe`` under ``compute-sanitizer --tool tool``: None when its
    kernel ran and the tool reported nothing, else the tool's Result,
    ``refused`` when compute-sanitizer refused the card."""
    t0 = time.perf_counter()
    out, text, rc = _card_child(
        tool, [sys.executable, "-c", "from tpu_cnn_torch.apps.sanitize import probe; probe()"],
        build_dir, deadline)
    if PROBE_RAN in out and rc == 0:
        return None
    refused = DEVICE_REFUSED in text + out and PROBE_RAN not in out
    if refused:
        detail = (f"compute-sanitizer refused the card ({DEVICE_REFUSED!r}): the "
                  f"probe's kernel did not run")
    else:
        detail = f"the probe failed under the tool (exit {rc})"
        sys.stderr.write((text + out)[-8000:])
    return Result(tool, f"the probe kernel under compute-sanitizer --tool {tool}", None,
                  time.perf_counter() - t0, False, detail, refused=refused)


def card_lane(tool: str, build_dir: str, deadline: float) -> Result:
    """``apps.kernel_cases`` under ``compute-sanitizer --tool tool`` (and,
    for memcheck, the canary in a child of its own)."""
    t0 = time.perf_counter()
    ran = f"apps.kernel_cases under compute-sanitizer --tool {tool}"
    out, text, rc = _card_child(
        tool, [sys.executable, "-m", "tpu_cnn_torch.apps.kernel_cases"], build_dir, deadline)
    reports, ok, detail = parse_sanitizer(tool, text + out, rc)
    child = _child_report(out)
    # refused only when nothing ran: the child never reported its launches
    res = Result(tool, ran, reports, 0.0, ok, detail,
                 launches=child and child["launches"], paths=child and child["paths"],
                 refused=DEVICE_REFUSED in text + out and child is None)
    if ok:
        unlaunched = [k for k in KERNELS if not (child and child["launches"].get(k))]
        missing = child["missing_paths"] if child else ["(no report from the child)"]
        if unlaunched or missing:
            res.ok = False
            res.detail = f"not launched: {unlaunched}; paths not reached: {missing}"
    if tool == "memcheck":
        cout, ctext, crc = _card_child(
            tool, [sys.executable, "-c",
                   "from tpu_cnn_torch.apps.sanitize import canary; canary()"],
            build_dir, deadline)
        creports, _ok, cdetail = parse_sanitizer(tool, ctext + cout, crc)
        res.canary = bool(creports) and "narrow_kernel" in ctext
        if not res.canary:
            res.ok = False
            res.detail += f"; the canary was not caught ({cdetail})"
        else:
            res.detail += f"; the canary caught ({creports} reports)"
    if not res.ok:
        sys.stderr.write((text + out)[-20000:])
    res.seconds = time.perf_counter() - t0
    return res


def _spent(tool: str, timeout: float) -> Result:
    return Result(tool, "nothing", None, 0.0, False,
                  f"not run: the --timeout of {timeout:.0f} s was spent")


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("tools", nargs="+", choices=HOST_TOOLS + CARD_TOOLS)
    p.add_argument("--tests", nargs="*", default=(),
                   help="asan/tsan: test files or node ids in place of "
                        "NATIVE_TEST_FILES (their native tests run)")
    p.add_argument("--timeout", type=float, default=900.0,
                   help="seconds the whole run may take (default %(default)s)")
    p.add_argument("--json", action="store_true",
                   help="also print one JSON object per tool")
    args = p.parse_args(argv)
    deadline = time.monotonic() + args.timeout
    results = []
    for tool in args.tools:
        if tool in HOST_TOOLS:
            results.append(host_lane(tool, args.tests, deadline)
                           if time.monotonic() < deadline else _spent(tool, args.timeout))
    card = [t for t in args.tools if t in CARD_TOOLS]
    if card:
        with tempfile.TemporaryDirectory(prefix="tcnn_cs_") as build_dir:
            probed = {t: probe_tool(t, build_dir, deadline) for t in card}
            results += [r for r in probed.values() if r is not None]
            if any(r is None for r in probed.values()):
                t0 = time.perf_counter()
                libs = build_kernels(build_dir, deadline)
                print(f"[sanitize] built {', '.join(os.path.basename(v) for v in libs.values())} "
                      f"with -lineinfo in {time.perf_counter() - t0:.1f} s", flush=True)
            for tool in (t for t, r in probed.items() if r is None):
                results.append(card_lane(tool, build_dir, deadline)
                               if time.monotonic() < deadline else _spent(tool, args.timeout))
    for r in results:
        print(r.line(), flush=True)
        if args.json:
            print(json.dumps({"sanitize": dataclasses.asdict(r)}), flush=True)
    return 0 if all(r.ok for r in results) else 1


if __name__ == "__main__":
    sys.exit(main())
