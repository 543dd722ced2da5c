"""The sanitizer lane (``tpu_cnn_torch.apps.sanitize``) and what it stands
on, and the last loose ends of the numpy/torch contract.

- The build cache's isolation (``ops._build``): with its variables unset
  every library's path and name is what the parent formula gives
  (``NVCC_FLAGS`` or ``GXX_FLAG_SETS`` hashed with the sources, in
  ``build/tpu_cnn_torch``); extra flags change the digest and the name;
  the directory override moves the cache; a deployable's library built
  clean is not installed under an instrumented build's name. Path
  arithmetic only: no nvcc.
- The lane's readers on captured text of each tool: clean summaries,
  errors, a racecheck hazard, a missing summary, a killed child, the
  card's refusal. Every case but the clean ones fails.
- The ``asan`` lane itself, in a child, on the oracle and ring tests.
- The native oracle against the numpy contract on edge images and shift
  changes (the JAX lane's ``edge_images`` and ``shift_variation``), and
  the ring under concurrent producers and a consumer, marked ``native``
  for the lane.
- The code paths the kernel cases require, as the libraries count them
  (``csrc/path_counts.cuh``, ``ops._build.path_counts``), and the card
  tools' verdicts: refused only when nothing ran, failed on any report.
- ``quant.cnn_forward_chunked``, ``weights.validate_stock_blob`` and
  ``models.cnn.layer_weight_sizes`` against the JAX functions on seeded
  numpy inputs: integer results, compared exactly.
"""

import ctypes
import io
import json
import os
import re
import subprocess
import sys
import threading
import zipfile

import numpy as np
import pytest

torch = pytest.importorskip(
    "torch", reason="torch not installed: the PyTorch port cannot be tested")

import jax.numpy as jnp  # noqa: E402

from tpu_cnn.models import cnn as j_cnn  # noqa: E402
from tpu_cnn.ops import quant as j_quant  # noqa: E402
from tpu_cnn.utils import weights as j_weights  # noqa: E402
from tpu_cnn_torch import deploy  # noqa: E402
from tpu_cnn_torch.apps import kernel_cases, sanitize  # noqa: E402
from tpu_cnn_torch.engine.cpu_ref import numpy_cnn_forward  # noqa: E402
from tpu_cnn_torch.models import cnn  # noqa: E402
from tpu_cnn_torch.models.registry import default_shifts, get_config  # noqa: E402
from tpu_cnn_torch.native.oracle import NativeOracle  # noqa: E402
from tpu_cnn_torch.ops import _build, quant  # noqa: E402
from tpu_cnn_torch.utils import artifacts as art  # noqa: E402
from tpu_cnn_torch.utils import weights  # noqa: E402

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
VARS = ("TPU_CNN_TORCH_BUILD_DIR", "TPU_CNN_TORCH_EXTRA_CXXFLAGS",
        "TPU_CNN_TORCH_EXTRA_NVCCFLAGS")
LIBS = (*sanitize.KERNELS, "tcnn_host")


@pytest.fixture
def unset(monkeypatch):
    for var in VARS:
        monkeypatch.delenv(var, raising=False)
    return monkeypatch


def _library(name: str) -> str:
    return _build.host_library() if name == "tcnn_host" else _build.kernel_library(name)


def _parent_name(name: str) -> str:
    """The library's path as the cache named it before the variables
    existed: the sources hashed with the flag constants."""
    if name == "tcnn_host":
        srcs = [os.path.join(_build.NATIVE_DIR, f) for f in _build.HOST_SOURCES]
        digest = _build.source_digest(srcs, repr(_build.GXX_FLAG_SETS).encode())
    else:
        digest = _build.source_digest(os.path.join(_build.CSRC_DIR, name + ".cu"),
                                      repr(_build.NVCC_FLAGS).encode())
    return os.path.join(REPO, "build", "tpu_cnn_torch", f"lib{name}_{digest[:16]}.so")


# ── the build cache's isolation ──────────────────────────────────────


@pytest.mark.parametrize("name", LIBS)
def test_unset_variables_keep_every_name(unset, name):
    assert _build.build_dir() == _build.BUILD_DIR
    # the package may be imported through a path like tests/..
    assert os.path.realpath(_library(name)) == os.path.realpath(_parent_name(name))


@pytest.mark.parametrize("name", LIBS)
@pytest.mark.parametrize("var,flags", [
    ("TPU_CNN_TORCH_EXTRA_NVCCFLAGS", "-lineinfo"),
    ("TPU_CNN_TORCH_EXTRA_CXXFLAGS", "-fsanitize=address -g")])
def test_extra_flags_rename_only_their_libraries(unset, name, var, flags):
    clean = _library(name)
    unset.setenv(var, flags)
    renamed = (name == "tcnn_host") == (var == "TPU_CNN_TORCH_EXTRA_CXXFLAGS")
    assert (_library(name) != clean) == renamed
    assert os.path.dirname(_library(name)) == os.path.dirname(clean)
    if renamed:  # the flags are in the command and in the digest
        got = _build.gxx_flag_sets()[0] if name == "tcnn_host" else _build.nvcc_flags()
        assert got[-len(flags.split()):] == flags.split()


@pytest.mark.parametrize("name", LIBS)
def test_build_dir_override_moves_the_cache(unset, name, tmp_path):
    clean = _library(name)
    unset.setenv("TPU_CNN_TORCH_BUILD_DIR", str(tmp_path))
    assert _library(name) == os.path.join(tmp_path, os.path.basename(clean))


@pytest.mark.parametrize("extra", [None, "-lineinfo"])
def test_deployable_installs_a_clean_library_only_under_its_clean_name(
        unset, tmp_path, extra):
    """A manifest entry carries the digest of the build that exported it;
    under extra flags the digest differs, so the clean library is not
    installed where the instrumented one would be looked for."""
    unset.setenv("TPU_CNN_TORCH_BUILD_DIR", str(tmp_path))
    entry = {"name": "bitcast", "digest": _build.kernel_digest("bitcast"),
             "arch": _build.ARCH, "file": "kernels/sm_90a/libbitcast.so"}
    buf = io.BytesIO()
    with zipfile.ZipFile(buf, "w") as z:
        z.writestr(entry["file"], b"a clean build")
    if extra:
        unset.setenv("TPU_CNN_TORCH_EXTRA_NVCCFLAGS", extra)
    with zipfile.ZipFile(buf) as z:
        copied = deploy.install_kernel_libraries(z, {"kernel_libraries": [entry]})
    assert copied == ([] if extra else ["bitcast"])
    assert os.path.exists(_build.kernel_library("bitcast")) == (extra is None)


# ── the lane's readers ───────────────────────────────────────────────


CS = "========= COMPUTE-SANITIZER\n"
MEMCHECK_ERRORS = (
    CS + "========= Invalid __global__ read of size 4 bytes\n"
    "=========     at narrow_kernel<(int)1>(const unsigned int *, unsigned char *, "
    "unsigned long, unsigned long)+0x90 in bitcast.cu:80\n"
    "=========     by thread (0,0,0) in block (0,40,0)\n"
    "========= ERROR SUMMARY: 2 errors\n")
RACE_HAZARD = (
    CS + "========= Error: Race reported between Write access at "
    "conv_layer_kernel<true, false, 32>(LayerArgs)+0x1a0 in conv_layer.cuh:470\n"
    "=========     and Read access at conv_layer_kernel<true, false, 32>(LayerArgs)"
    "+0x2c0 in conv_layer.cuh:477 [512 hazards]\n"
    "========= RACECHECK SUMMARY: 1 hazard displayed (1 error, 0 warnings)\n")
REFUSED = (CS + "========= Error: Device not supported. Please refer to the "
           '"Supported Devices" section of the sanitizer documentation\n'
           "========= Target application returned an error\n"
           "========= ERROR SUMMARY: 1 error\n")
SANITIZER_CASES = {  # (tool, captured text, exit code) -> (reports, ok)
    "memcheck clean": ("memcheck", CS + "========= ERROR SUMMARY: 0 errors\n", 0, 0, True),
    "initcheck clean": ("initcheck", CS + "========= ERROR SUMMARY: 0 errors\n", 0, 0, True),
    "racecheck clean": ("racecheck", CS + "========= RACECHECK SUMMARY: 0 hazards "
                        "displayed (0 errors, 0 warnings)\n", 0, 0, True),
    "memcheck errors": ("memcheck", MEMCHECK_ERRORS, sanitize.ERROR_EXITCODE, 2, False),
    "synccheck errors": ("synccheck", CS + "========= Barrier error detected. "
                         "Divergent thread(s) in block\n========= ERROR SUMMARY: 1 error\n",
                         sanitize.ERROR_EXITCODE, 1, False),
    "racecheck hazard": ("racecheck", RACE_HAZARD, sanitize.ERROR_EXITCODE, 1, False),
    "racecheck read as memcheck": ("memcheck", RACE_HAZARD, 0, None, False),
    "missing summary": ("memcheck", CS, 0, None, False),
    "no output": ("initcheck", "", 0, None, False),
    "killed child": ("memcheck", CS + "========= ERROR SUMMARY: 0 errors\n", -9, 0, False),
    "child failed": ("memcheck", CS + "========= ERROR SUMMARY: 0 errors\n", 1, 0, False),
    "device refused": ("memcheck", REFUSED, sanitize.ERROR_EXITCODE, 1, False),
}


@pytest.mark.parametrize("case", sorted(SANITIZER_CASES))
def test_sanitizer_reader(case):
    tool, text, rc, reports, ok = SANITIZER_CASES[case]
    got_reports, got_ok, detail = sanitize.parse_sanitizer(tool, text, rc)
    assert (got_reports, got_ok) == (reports, ok), detail
    assert ("refused" in detail) == (case == "device refused")


ASAN_REPORT = ("==12==ERROR: AddressSanitizer: heap-buffer-overflow on address "
               "0x602000000054\n    #0 0x7f in ring_push frame_ring.cpp:88\n")
TSAN_REPORT = ("==================\nWARNING: ThreadSanitizer: data race (pid=7)\n"
               "  Write of size 8 at 0x7b04 by thread T2:\n    #0 front_loop "
               "http_front.cpp:120\n==================\n"
               "ThreadSanitizer: reported 1 warnings\n")
PASSED = "...................\n19 passed, 86 deselected in 61.20s (0:01:01)\n"
HOST_CASES = {  # (tool, captured text, exit code) -> (reports, ok)
    "asan clean": ("asan", PASSED, 0, 0, True),
    "tsan clean": ("tsan", PASSED, 0, 0, True),
    "asan report, child aborted": ("asan", "....." + ASAN_REPORT, -6, 1, False),
    "asan report in its log": ("asan", PASSED + ASAN_REPORT, 0, 1, False),
    "tsan report": ("tsan", PASSED + TSAN_REPORT, 66, 1, False),
    "tsan exit 66 unread": ("tsan", PASSED, 66, 0, False),
    "failed test": ("asan", ".F.\n1 failed, 2 passed in 3.10s\n", 1, 0, False),
    "no test ran": ("asan", "86 deselected in 1.20s\n", 5, 0, False),
    "missing summary": ("tsan", "....", 0, None, False),
    "killed child": ("asan", "....\n(killed after 600 s)", -9, 0, False),
}


@pytest.mark.parametrize("case", sorted(HOST_CASES))
def test_host_lane_reader(case):
    tool, text, rc, reports, ok = HOST_CASES[case]
    got_reports, got_ok, detail = sanitize.parse_host(tool, text, rc)
    assert (got_reports, got_ok) == (reports, ok), detail
    if ok:
        assert detail == "19 tests passed"


def test_kernel_filter_names_every_kernel_of_the_sources(monkeypatch):
    """The card tools check the kernels their sources declare (a renamed
    kernel renames its filter), and initcheck checks every kernel."""
    names = {k: sanitize.kernel_functions(k) for k in sanitize.KERNELS}
    assert names == {"mega_cnn": ["mega_cnn_kernel"],
                     "conv_pool_layer": ["conv_layer_kernel"],
                     "conv_act": ["conv_layer_kernel"],
                     "bitcast": ["narrow_kernel", "roll_kernel", "widen_kernel"],
                     "cam_head": ["cam_head_kernel"],
                     "region_layer": ["conv_layer_kernel"]}
    monkeypatch.setattr(sanitize, "compute_sanitizer", lambda: "compute-sanitizer")
    filters = {tool: [a for a in sanitize.sanitizer_argv(tool, "log") if a.startswith("kns=")]
               for tool in sanitize.CARD_TOOLS}
    want = [f"kns={f}" for f in ("cam_head_kernel", "conv_layer_kernel", "mega_cnn_kernel",
                                 "narrow_kernel", "roll_kernel", "widen_kernel")]
    assert filters == {"memcheck": want, "racecheck": want, "synccheck": want,
                       "initcheck": []}


# ── the asan lane itself ─────────────────────────────────────────────


def test_asan_lane_on_the_oracle_and_ring_tests(tmp_path):
    """``python -m tpu_cnn_torch.apps.sanitize asan`` on the native
    oracle's and the ring's tests: the host library rebuilt with
    -fsanitize=address, the tests run with the runtime preloaded, a
    non-zero count of them passed and no report."""
    tests = ["tests/test_torch_copies.py::test_native_oracle_equals_the_original",
             "tests/test_torch_native_front.py::test_ring_push_pop_equals_the_jax_ring",
             "tests/test_torch_native_front.py::test_ring_threaded_producers_and_wait"]
    env = dict(os.environ, TMPDIR=str(tmp_path))
    proc = subprocess.run([sys.executable, "-m", "tpu_cnn_torch.apps.sanitize", "asan",
                           "--json", "--timeout", "170", "--tests", *tests],
                          cwd=REPO, env=env, capture_output=True, text=True, timeout=180)
    results = [json.loads(line)["sanitize"] for line in proc.stdout.splitlines()
               if line.startswith('{"sanitize"')]
    assert proc.returncode == 0 and len(results) == 1, proc.stdout + proc.stderr[-4000:]
    r = results[0]
    assert r["ok"] and r["reports"] == 0, r
    assert r["detail"] == "6 tests passed", r


# ── the native oracle on edge images (run by the ASan/TSan lane) ─────


@pytest.mark.native
@pytest.mark.parametrize("shifts", [(2, 4, 6), (1, 3, 5), (0, 0, 0), (31, 31, 31)])
def test_native_oracle_edge_images_and_shifts(shifts):
    """All-zero, all-255 and ramp images (padding and saturation corners)
    through the shipped lyr3-std weights at several shift registers: the
    C++ oracle equal to the numpy contract, one image and the batch."""
    kernels = art.load_bundle(kernel_cases.ARTIFACTS["lyr3-std"]).kernels
    ramp = (np.add.outer(np.arange(128), np.arange(128)) % 256).astype(np.uint8)
    imgs = np.stack([np.zeros((128, 128), np.uint8),
                     np.full((128, 128), 255, np.uint8), ramp])
    oracle = NativeOracle()
    want = np.stack([numpy_cnn_forward(im, kernels, shifts) for im in imgs])
    np.testing.assert_array_equal(oracle.infer_batch(imgs, kernels, shifts), want)
    np.testing.assert_array_equal(oracle.infer(ramp, kernels, shifts), want[2])


@pytest.mark.native
def test_ring_under_concurrent_producers_and_a_consumer():
    """Twice as many producer threads as cores push while a consumer pops
    and reads the drop count and the age (each call leaves the GIL, and
    the switch interval is short): every frame is popped or dropped.
    Under the TSan lane an unguarded read or write of the ring's state
    races here."""
    from tpu_cnn_torch.native.ring import NativeFrameRing

    frames = np.random.RandomState(15).randint(0, 256, (8, 24, 24)).astype(np.uint8)
    n_threads, per_thread = 2 * (os.cpu_count() or 4), 60
    ring = NativeFrameRing(capacity=16, out_size=8)
    popped, stop = [], threading.Event()

    def produce():
        for i in range(per_thread):
            ring.push(frames[i % len(frames)])

    def consume():
        while not stop.is_set():
            popped.append(len(ring.pop_batch(4)))
            assert ring.dropped >= 0 and ring.age_s() >= 0.0

    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-5)
    consumer = threading.Thread(target=consume)
    producers = [threading.Thread(target=produce) for _ in range(n_threads)]
    try:
        consumer.start()
        for t in producers:
            t.start()
        for t in producers:
            t.join(timeout=60)
            assert not t.is_alive()
    finally:
        stop.set()
        consumer.join(timeout=60)
        sys.setswitchinterval(interval)
    try:
        assert not consumer.is_alive()
        while len(got := ring.pop_batch(16)):
            popped.append(len(got))
        assert sum(popped) + ring.dropped == n_threads * per_thread
    finally:
        ring.close()


# ── the code paths the kernel cases name ─────────────────────────────


def _path_tables() -> dict[str, list[str]]:
    """Each library's path names, read from the table its sources declare
    (``constexpr const char* k...PathNames[...] = {...};``)."""
    tables = {}
    for name in kernel_cases.MODULES:
        text = b"".join(t for _p, t in _build.local_sources(
            os.path.join(_build.CSRC_DIR, name + ".cu"))).decode()
        found = re.findall(r"PathNames\[\w+\] = \{(.*?)\};", text, re.S)
        assert len(found) == 1, name
        tables[name] = re.findall(r'"([^"]*)"', found[0])
    return tables


@pytest.mark.parametrize("path", kernel_cases.REQUIRED_PATHS)
def test_required_paths_are_counted_by_the_launchers(path):
    """Every required path is one a library counts where it launches (a
    renamed or dropped path fails here, not silently on the card)."""
    prefix, name = path.split(": ", 1)
    assert any(name in table for lib, table in _path_tables().items()
               if kernel_cases.PATH_PREFIX[lib] == prefix), path


def test_each_library_exports_its_path_counts():
    sources = {name: open(os.path.join(_build.CSRC_DIR, name + ".cu")).read()
               for name in kernel_cases.MODULES}
    for name, text in sources.items():
        assert f'extern "C" int {name}_paths(const char** names' in text, name
    tables = _path_tables()
    assert tables["conv_act"] == tables["conv_pool_layer"]  # one launcher
    assert all(len(set(t)) == len(t) for t in tables.values())


def test_path_counts_reads_what_the_launchers_counted(monkeypatch, tmp_path):
    """``_build.path_counts`` on a library built (g++) on
    ``csrc/path_counts.cuh`` that counted two paths: every name, in the
    table's order, with its count."""
    src = tmp_path / "t.cpp"
    src.write_text(f'''#include "{os.path.join(_build.CSRC_DIR, "path_counts.cuh")}"
enum P {{ kA, kB, kC, kN }};
constexpr const char* kNames[kN] = {{"a", "b, c", "d >= 1"}};
PathCounts<kN> g_paths(kNames);
extern "C" int t_paths(const char** n, unsigned long long* h, int k) {{
  return g_paths.read(n, h, k);
}}
extern "C" void t_add(int i) {{ g_paths.add(i); }}
''')
    lib = tmp_path / "libt.so"
    subprocess.run(["g++", "-std=c++17", "-shared", "-fPIC", "-O2", "-o", str(lib), str(src)],
                   check=True)
    cdll = ctypes.CDLL(str(lib))
    for i in (1, 2, 1):
        cdll.t_add(i)
    monkeypatch.setattr(_build, "load", lambda name: cdll)
    assert _build.path_counts("t") == {"a": 0, "b, c": 2, "d >= 1": 1}


def test_bitcast_cases_on_the_plain_versions():
    """On the CPU the wrappers run the plain versions: the bitcast cases
    (the shapes, the shifts and the offset views) all agree."""
    assert kernel_cases.bitcast_vs_plain(torch.device("cpu")) == (0.0, 30)


# ── the card tools' verdicts ─────────────────────────────────────────


CHILD_JSON = json.dumps({"launches": dict.fromkeys(sanitize.KERNELS, 3),
                         "paths": list(kernel_cases.REQUIRED_PATHS), "missing_paths": []})
PROBE_CASES = {  # (the probe's output, the tool's log, exit code) -> None or (refused,)
    "ran": (sanitize.PROBE_RAN + "\n", CS + "========= ERROR SUMMARY: 0 errors\n", 0, None),
    "refused": ("probe: cuMemAlloc_v2 returned CUDA error 999\n", REFUSED, 1, True),
    "ran, reported": (sanitize.PROBE_RAN + "\n", MEMCHECK_ERRORS, 86, False),
    "failed": ("probe: cuInit returned CUDA error 100\n", CS, 1, False),
}


@pytest.mark.parametrize("case", sorted(PROBE_CASES))
def test_probe_decides_refused_only_when_its_kernel_did_not_run(monkeypatch, case):
    out, log, rc, want = PROBE_CASES[case]
    monkeypatch.setattr(sanitize, "_card_child", lambda *a: (out, log, rc))
    got = sanitize.probe_tool("memcheck", "unused", float("inf"))
    if want is None:
        assert got is None
    else:
        assert not got.ok and got.refused == want, got


LANE_CASES = {  # (the child's output, the tool's log, exit code) -> (refused, ok)
    "clean": (CHILD_JSON + "\n", CS + "========= ERROR SUMMARY: 0 errors\n", 0, False, True),
    "refused, nothing ran": ("", REFUSED, 1, True, False),
    # the refusal's text beside a child that ran and reports: counted, not refused
    "refusal text, the child ran": (CHILD_JSON + "\n", REFUSED.replace("1 error", "3 errors"),
                                    86, False, False),
    "reports": (CHILD_JSON + "\n", MEMCHECK_ERRORS, 86, False, False),
    "path not taken": (CHILD_JSON.replace('"missing_paths": []', '"missing_paths": ["x"]')
                       + "\n", CS + "========= ERROR SUMMARY: 0 errors\n", 0, False, False),
}


@pytest.mark.parametrize("case", sorted(LANE_CASES))
def test_card_lane_fails_on_any_report_and_refuses_only_unrun(monkeypatch, case):
    out, log, rc, refused, ok = LANE_CASES[case]
    monkeypatch.setattr(sanitize, "_card_child", lambda *a: (out, log, rc))
    r = sanitize.card_lane("racecheck" if "racecheck" in log else "initcheck", "unused",
                           float("inf"))
    assert (r.refused, r.ok) == (refused, ok), r


def test_a_spent_timeout_fails_the_tools_unrun(capsys):
    assert sanitize.main(["asan", "tsan", "--timeout", "0", "--json"]) == 1
    lines = [json.loads(line)["sanitize"] for line in capsys.readouterr().out.splitlines()
             if line.startswith('{"sanitize"')]
    assert [(r["tool"], r["ok"], r["detail"]) for r in lines] == [
        (t, False, "not run: the --timeout of 0 s was spent") for t in ("asan", "tsan")]


# ── the loose ends ───────────────────────────────────────────────────


@pytest.mark.parametrize("batch", [3, 4, 8])
def test_cnn_forward_chunked_equals_the_jax_function(batch):
    """lyr3-tiny at chunk 4: a batch within one chunk, exactly one, and
    two chunks; equal to the JAX function and to ``cnn_forward``."""
    rs = np.random.RandomState(14)
    cfg = get_config("lyr3-tiny")
    kernels = [rs.randint(-127, 128, (oc, ic, 3, 3)).astype(np.int8)
               for ic, oc, _ in cfg.layer_configs]
    shifts = np.asarray(default_shifts(cfg), np.int32)
    imgs = rs.randint(0, 256, (batch, cfg.img_size, cfg.img_size)).astype(np.uint8)
    ks = [torch.from_numpy(k) for k in kernels]
    got = quant.cnn_forward_chunked(torch.from_numpy(imgs), ks,
                                    torch.from_numpy(shifts), chunk=4).numpy()
    want = np.asarray(j_quant.cnn_forward_chunked(
        jnp.asarray(imgs), [jnp.asarray(k) for k in kernels], jnp.asarray(shifts),
        chunk=4))
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(got, quant.cnn_forward(
        torch.from_numpy(imgs), ks, torch.from_numpy(shifts)).numpy())


def test_cnn_forward_chunked_refuses_a_ragged_batch():
    """The JAX function asserts a batch above ``chunk`` is a multiple of
    it; the port raises."""
    imgs = torch.zeros((6, 32, 32), dtype=torch.uint8)
    ks = [torch.zeros((16, 1, 3, 3), dtype=torch.int8)]
    with pytest.raises(ValueError, match="multiple of chunk=4"):
        quant.cnn_forward_chunked(imgs, ks, torch.zeros(1, dtype=torch.int32), chunk=4)


@pytest.mark.parametrize("blob", [
    bytes(23184), np.zeros(23184, np.int8), bytes(100), np.zeros((3, 7), np.uint8),
    bytearray(23185)], ids=["good bytes", "good array", "short", "short array", "long"])
def test_validate_stock_blob_equals_the_jax_function(blob):
    def outcome(fn):
        try:
            fn(blob)
        except ValueError as e:
            return str(e)
        return None

    got = outcome(weights.validate_stock_blob)
    assert got == outcome(j_weights.validate_stock_blob)
    assert (got is None) == (np.asarray(bytearray(blob) if isinstance(
        blob, (bytes, bytearray)) else blob).size == cnn.WEIGHT_BYTES)


def test_layer_weight_sizes_equal_the_jax_function():
    assert cnn.layer_weight_sizes() == j_cnn.layer_weight_sizes() == [144, 4608, 18432]
    assert sum(cnn.layer_weight_sizes()) == cnn.WEIGHT_BYTES == j_cnn.WEIGHT_BYTES
