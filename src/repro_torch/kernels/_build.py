"""Build the port's CUDA sources with ``nvcc`` and load them with ``ctypes``.

Each ``csrc/<name>.cu`` exposes a plain C interface and is compiled at first
use into ``_build/lib<name>-<hash>.so`` beside this module (a git-ignored
directory), keyed by a hash of the source, every shared ``csrc/*.cuh``
header and the flags, so an edit to any of them rebuilds. ptxas reports
each kernel's registers and spills (``-Xptxas -v``) into a ``.log`` beside
the library, which :func:`ptxas_report` reads. Nothing is built or imported
when this module is imported.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import re
import shutil
import subprocess
import tempfile
from pathlib import Path
from typing import Dict, Iterable, List, Mapping, Sequence

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parent / "_build"

#: nvcc flags. -fmad=false keeps a*b+c as two roundings (the plain PyTorch
#: versions round every operation); no --use_fast_math, so division,
#: floorf and rintf stay IEEE.
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-fmad=false", "-Xptxas", "-v", "-shared", "-Xcompiler",
              "-fPIC")

_LOADED: Dict[str, ctypes.CDLL] = {}
#: Libraries compiled or loaded by :func:`load` in this process (cache
#: misses): runners add the ones loaded for them to their ``trace_count``.
_LOADS = [0]
#: Calls of :func:`forget` so far: a CUDA graph captured before the last
#: one holds kernel handles of unloaded libraries.
_FORGETS = [0]


def nvcc_path() -> str:
    """``nvcc`` from ``PATH``, else from ``$CUDA_HOME/bin``."""
    found = shutil.which("nvcc")
    if found:
        return found
    home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    candidate = Path(home) / "bin" / "nvcc"
    if candidate.exists():
        return str(candidate)
    raise RuntimeError("nvcc not found on PATH or under $CUDA_HOME/bin; the "
                       "CUDA kernels are built on a machine with the toolkit")


def library_path(name: str) -> Path:
    """The library's path, keyed by the bytes of ``csrc/<name>.cu``, of
    every ``csrc/*.cuh`` it may include, and of the flags."""
    digest = hashlib.sha256((CSRC / f"{name}.cu").read_bytes())
    for header in sorted(CSRC.glob("*.cuh")):
        digest.update(header.name.encode() + b"\0" + header.read_bytes())
    digest.update(" ".join(NVCC_FLAGS).encode())
    return BUILD_DIR / f"lib{name}-{digest.hexdigest()[:12]}.so"


def build(names: Iterable[str]) -> List[Path]:
    """Compile every source in ``names`` that is not built yet, one ``nvcc``
    per source, all started together. Raises with the compiler's output if
    any build fails."""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    nvcc = None
    jobs = []
    names = list(names)
    for name in names:
        out = library_path(name)
        if out.exists():
            continue
        nvcc = nvcc or nvcc_path()
        fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
        os.close(fd)
        cmd = [nvcc, *NVCC_FLAGS, "-o", tmp, str(CSRC / f"{name}.cu")]
        proc = subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                stderr=subprocess.STDOUT, text=True)
        jobs.append((name, out, tmp, proc))
    failures = []
    for name, out, tmp, proc in jobs:
        log, _ = proc.communicate()
        if proc.returncode == 0:
            out.with_suffix(".log").write_text(log)
            os.replace(tmp, out)  # atomic: concurrent builders race safely
        else:
            os.unlink(tmp)
            failures.append(f"nvcc failed for {name}.cu "
                            f"(exit {proc.returncode}):\n{log}")
    if failures:
        raise RuntimeError("\n".join(failures))
    return [library_path(n) for n in names]


def kernel_name(mangled: str) -> str:
    """A kernel's name from its mangled one, with its int and bool template
    arguments as C++ writes them (``kinetic_chunk_kernel<2, true>``: the
    persistent kernels' agent mode and cluster flag)."""
    m = re.match(r"_Z(\d+)(\w+)", mangled)
    n, rest = int(m.group(1)), m.group(2)
    args = re.match(r"I((?:L[ib]\d+E)+)E", rest[n:])
    if not args:
        return rest[:n]
    vals = [v if t == "i" else ("false", "true")[int(v)]
            for t, v in re.findall(r"L([ib])(\d+)E", args.group(1))]
    return f"{rest[:n]}<{', '.join(vals)}>"


def ptxas_report(name: str) -> Dict[str, dict]:
    """Registers and spill bytes of each kernel of a built library, from
    ptxas's ``-v`` report, keyed by :func:`kernel_name`."""
    report, kernel = {}, None
    log = library_path(name).with_suffix(".log").read_text()
    for line in log.splitlines():
        m = re.search(r"Compiling entry function '(_Z\d+\w+)'", line)
        if m:
            kernel = kernel_name(m.group(1))
            report[kernel] = {}
            continue
        m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads",
                      line)
        if m and kernel:
            report[kernel].update(spill_stores=int(m.group(1)),
                                  spill_loads=int(m.group(2)))
        m = re.search(r"Used (\d+) registers", line)
        if m and kernel:
            report[kernel]["registers"] = int(m.group(1))
    return report


def load(name: str, entries: Mapping[str, Sequence] = ()) -> ctypes.CDLL:
    """The loaded library for ``csrc/<name>.cu``, building it if needed.

    At first load the library's exported column order is checked against
    :mod:`repro_torch.core.params`, and each C entry in ``entries`` gets its
    ``argtypes`` (pointers and the stream as ``c_void_p``) and an ``int``
    (``cudaError_t``) return.
    """
    lib = _LOADED.get(name)
    if lib is None:
        path, = build([name])
        lib = ctypes.CDLL(str(path))
        _check_columns(lib, name)
        for fn, argtypes in dict(entries).items():
            getattr(lib, fn).argtypes = list(argtypes)
            getattr(lib, fn).restype = ctypes.c_int
        _LOADED[name] = lib
        _LOADS[0] += 1
    return lib


def load_count() -> int:
    """Libraries compiled or loaded by :func:`load` so far."""
    return _LOADS[0]


def forget() -> None:
    """Drop the loaded libraries, so the next :func:`load` of each goes
    through the on-disk build again (a restart after a device fault;
    nothing is recompiled while the source is unchanged). Every CUDA
    graph captured before is dropped with them (:func:`forget_count`)."""
    _LOADED.clear()
    _FORGETS[0] += 1


def forget_count() -> int:
    """Calls of :func:`forget` so far (an engine drops its captured graphs
    when it changes)."""
    return _FORGETS[0]


def _check_columns(lib: ctypes.CDLL, name: str) -> None:
    from repro_torch.core.params import FLOAT_FIELDS, INT_FIELDS

    for fn in ("kc_float_cols", "kc_int_cols", "kc_error_string"):
        getattr(lib, fn).restype = ctypes.c_char_p
    lib.kc_error_string.argtypes = [ctypes.c_int]
    for fn, fields in (("kc_float_cols", FLOAT_FIELDS),
                       ("kc_int_cols", INT_FIELDS)):
        have = getattr(lib, fn)().decode()
        if have != ",".join(fields):
            raise RuntimeError(
                f"{name}.cu column order {have!r} disagrees with "
                f"repro_torch.core.params ({','.join(fields)!r})")


def check_launch(lib: ctypes.CDLL, rc: int, what: str) -> None:
    """Raise if a C entry returned a CUDA error."""
    if rc != 0:
        raise RuntimeError(f"{what} launch failed: CUDA error {rc} "
                           f"({lib.kc_error_string(rc).decode()})")


def ptr(t):
    """A tensor's device address for a ``c_void_p`` argument (None: null)."""
    return None if t is None else t.data_ptr()
