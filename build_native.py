#!/usr/bin/env python
"""Build the native host extensions into the package directory.

    python build_native.py

Two C extensions, both optional at import time (pure-Python fallbacks exist,
roughly 13x slower on the Whisk paths):
  * _keccak_native (csrc/keccak.c): Keccak-f[1600] and the Merlin transcript.
  * _g1_native (csrc/g1.c): host BLS12-381 Fq/G1 backend — Montgomery limb
    arithmetic, Jacobian point ops, Pippenger MSM, batched compressed serde
    and the stream MSM's host prep (GLV split, digits, sort).

They are compiled with the system C compiler against this interpreter's
headers (sysconfig), so no build tool beyond the compiler is needed. Import
`ensure_native()` BEFORE importing curdleproofs_jax: the curve module binds
the extension when it is first imported.
"""
from __future__ import annotations

import os
import shutil
import subprocess
import sys
import sysconfig
import tempfile

HERE = os.path.dirname(os.path.abspath(__file__))
PKG = os.path.join(HERE, "curdleproofs_jax")

# name -> (sources, OpenMP flags)
EXTENSIONS = {
    "_keccak_native": (["csrc/keccak.c"], []),
    "_g1_native": (["csrc/g1.c"], ["-fopenmp"]),
}


def _target(name: str) -> str:
    return os.path.join(PKG, name + sysconfig.get_config_var("EXT_SUFFIX"))


def _stale(name: str) -> bool:
    target = _target(name)
    if not os.path.exists(target):
        return True
    built = os.path.getmtime(target)
    srcs, _ = EXTENSIONS[name]
    return any(os.path.getmtime(os.path.join(HERE, s)) > built for s in srcs)


def _compilers() -> list:
    found = []
    for c in (os.environ.get("CC"), "cc", "gcc"):
        c = c and shutil.which(c)
        if c and c not in found:
            found.append(c)
    if not found:
        raise FileNotFoundError("no C compiler (cc/gcc) on PATH")
    return found


def build_one(name: str) -> str:
    """Compile one extension and return the command line that worked.
    OpenMP is asked for first; a compiler without it (no libgomp) builds
    the serial version. Raises CalledProcessError, with every compiler's
    output on stderr, if no attempt builds."""
    srcs, omp = EXTENSIONS[name]
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=PKG)
    os.close(fd)
    errors = []
    try:
        for extra in ([omp, []] if omp else [[]]):
            for cc in _compilers():
                cmd = (
                    [cc, "-shared", "-fPIC", "-O3", "-march=native", "-funroll-loops"]
                    + extra
                    + ["-I", sysconfig.get_paths()["include"]]
                    + [os.path.join(HERE, s) for s in srcs]
                    + ["-o", tmp]
                )
                r = subprocess.run(cmd, capture_output=True, text=True)
                if r.returncode == 0:
                    os.replace(tmp, _target(name))  # atomic for readers
                    return " ".join(cmd[:1] + extra)
                errors.append(r)
        for r in errors:
            sys.stderr.write(" ".join(r.args) + "\n" + (r.stderr or ""))
        raise subprocess.CalledProcessError(errors[-1].returncode, errors[-1].args)
    finally:
        if os.path.exists(tmp):
            os.remove(tmp)


def ensure_native() -> dict:
    """Build every missing or out-of-date extension; returns
    {name: compiler and flags used} for those built. Raises on a compiler
    failure."""
    return {name: build_one(name) for name in EXTENSIONS if _stale(name)}


if __name__ == "__main__":
    print("built:", ensure_native() or "nothing (up to date)")
