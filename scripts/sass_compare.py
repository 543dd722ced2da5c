"""Whether a kernel's instantiations compile to the same code in two
checkouts: the SASS of every function of the first checkout's library
against the second's.

    python scripts/sass_compare.py OLD_CHECKOUT NEW_CHECKOUT [--kernels conv_stream region_layer] [--out FILE]

Builds ``csrc/<kernel>.cu`` in each checkout with that checkout's own
``ops/_build.py`` (each into a kernel cache of its own under ``build/``),
dumps each library's SASS with ``cuobjdump -sass`` and, for every function
of the old library, looks for a function of the new one with the same
body: every instruction and its encoding, the addresses dropped, so a
function whose template gained an argument still matches under its new
name. Prints a line per kernel (functions on each side, old functions
matched) and each unmatched old function, and writes the whole table as
JSON to ``--out``. Exits 1 where an old function has no match. Needs nvcc
and cuobjdump (``/usr/local/cuda/bin``); no device.
"""

from __future__ import annotations

import argparse
import concurrent.futures
import json
import os
import re
import subprocess
import sys

CUOBJDUMP = "/usr/local/cuda/bin/cuobjdump"


def build(checkout: str, kernel: str, cache: str) -> str:
    """The library path of ``kernel`` built by ``checkout``'s own ``ops/_build.py``."""
    proc = subprocess.run(
        [sys.executable, "-c",
         f"from tpu_cnn_torch.ops import _build; print(_build.build({kernel!r})[0])"],
        cwd=checkout, capture_output=True, text=True,
        env={**os.environ, "TPU_CNN_TORCH_BUILD_DIR": cache})
    if proc.returncode:
        sys.exit(f"building {kernel} in {checkout} failed:\n{proc.stderr[-3000:]}")
    return proc.stdout.strip().splitlines()[-1]


def functions(lib: str) -> dict[str, str]:
    """Mangled name -> body (one instruction and its encoding a line)."""
    text = subprocess.run([CUOBJDUMP, "-sass", lib], capture_output=True, text=True,
                          check=True).stdout
    funs: dict[str, list[str]] = {}
    cur = None
    for line in text.splitlines():
        m = re.match(r"\s*Function : (\S+)", line)
        if m:
            cur = m.group(1)
            funs[cur] = []
        elif cur is not None and "/*" in line:
            body = re.sub(r"/\*[0-9a-f]{4,}\*/", "", line).strip()
            if body:
                funs[cur].append(body)
    return {name: "\n".join(body) for name, body in funs.items()}


def demangle(names: list[str]) -> dict[str, str]:
    out = subprocess.run(["c++filt"], input="\n".join(names), capture_output=True,
                         text=True).stdout.splitlines()
    return dict(zip(names, out)) if len(out) == len(names) else {n: n for n in names}


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("old")
    p.add_argument("new")
    p.add_argument("--kernels", nargs="+", default=["conv_stream", "region_layer"])
    p.add_argument("--out", default=None, help="write the table as JSON here")
    args = p.parse_args(argv)
    jobs = [(tree, k, os.path.abspath(os.path.join("build", f"sass_cache_{side}")))
            for k in args.kernels for side, tree in enumerate((args.old, args.new))]
    with concurrent.futures.ThreadPoolExecutor(len(jobs)) as pool:
        libs = dict(zip([(t, k) for t, k, _ in jobs], pool.map(lambda j: build(*j), jobs)))
    table, missing = {}, 0
    for k in args.kernels:
        old, new = functions(libs[(args.old, k)]), functions(libs[(args.new, k)])
        by_body: dict[str, list[str]] = {}
        for name, body in new.items():
            by_body.setdefault(body, []).append(name)
        names = demangle(list(old) + list(new))
        rows = [{"old": names[n], "instructions": body.count("\n") + 1,
                 "same_code_in_new": [names[m] for m in by_body.get(body, [])]}
                for n, body in old.items()]
        matched = sum(bool(r["same_code_in_new"]) for r in rows)
        missing += len(rows) - matched
        table[k] = {"old_functions": len(old), "new_functions": len(new),
                    "matched": matched, "rows": rows}
        print(f"{k}: {len(old)} old functions, {len(new)} new, {matched} of the old "
              f"with the same code in the new", flush=True)
        for r in rows:
            if not r["same_code_in_new"]:
                print(f"  no match: {r['old']} ({r['instructions']} instructions)")
    if args.out:
        with open(args.out, "w") as f:
            json.dump(table, f, indent=1)
    return 1 if missing else 0


if __name__ == "__main__":
    sys.exit(main())
