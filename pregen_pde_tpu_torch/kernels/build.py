"""Build and load the hand-written CUDA kernels (``csrc/*.cu``).

``nvcc -gencode arch=compute_90a,code=sm_90a -O3 -shared`` into a shared
library with a plain C interface, loaded with ctypes. The build happens at
first use into ``pregen_pde_tpu_torch/_build/`` (git-ignored), with the
source hash (the ``.cu`` and the ``csrc/*.cuh`` headers) in the artifact
name, so a changed source rebuilds and an
unchanged one loads in milliseconds. A missing ``nvcc`` or a failed build
raises, naming the cause; nothing falls back.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path

CSRC = Path(__file__).resolve().parent.parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parent.parent / "_build"
CUDA_HOME_DEFAULT = "/usr/local/cuda"
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC"]

_loaded: dict[str, ctypes.CDLL] = {}
# seconds the last build of each library took (0.0 when loaded from cache)
build_seconds: dict[str, float] = {}


def find_nvcc() -> str | None:
    """``$CUDA_HOME/bin/nvcc``, else ``nvcc`` on PATH, else the default
    toolkit location; None when there is none."""
    cands = []
    if os.environ.get("CUDA_HOME"):
        cands.append(os.path.join(os.environ["CUDA_HOME"], "bin", "nvcc"))
    on_path = shutil.which("nvcc")
    if on_path:
        cands.append(on_path)
    cands.append(os.path.join(CUDA_HOME_DEFAULT, "bin", "nvcc"))
    return next((c for c in cands if os.path.isfile(c) and os.access(c, os.X_OK)), None)


def library_path(name: str, build_dir: Path = BUILD_DIR, defines: tuple = ()) -> Path:
    # the headers a source may include count as part of it
    src = b"".join(p.read_bytes() for p in [CSRC / f"{name}.cu", *sorted(CSRC.glob("*.cuh"))])
    flags = " ".join([*NVCC_FLAGS, *(f"-D{d}" for d in defines)])
    tag = hashlib.sha256(src + flags.encode()).hexdigest()[:12]
    return build_dir / f"{name}_{tag}.so"


def build(name: str, build_dir: Path = BUILD_DIR, defines: tuple = ()) -> Path:
    """Compile ``csrc/<name>.cu`` (with ``-D`` for each of ``defines``: a
    profiling build) unless the hashed artifact exists."""
    so_path = library_path(name, build_dir, defines)
    if so_path.exists():
        build_seconds.setdefault(name, 0.0)
        return so_path
    nvcc = find_nvcc()
    if nvcc is None:
        raise RuntimeError(
            f"cannot build CUDA kernel {name!r}: nvcc not found (looked in "
            f"$CUDA_HOME/bin, PATH and {CUDA_HOME_DEFAULT}/bin)"
        )
    build_dir.mkdir(parents=True, exist_ok=True)
    tmp = so_path.with_suffix(f".{os.getpid()}.tmp")
    cmd = [nvcc, *NVCC_FLAGS, *(f"-D{d}" for d in defines), "-o", str(tmp),
           str(CSRC / f"{name}.cu")]
    t0 = time.perf_counter()
    proc = subprocess.run(cmd, capture_output=True, text=True)
    if proc.returncode != 0:
        raise RuntimeError(
            f"nvcc failed building {name!r} (rc {proc.returncode}):\n"
            f"{' '.join(cmd)}\n{proc.stdout}{proc.stderr}"
        )
    os.replace(tmp, so_path)  # atomic against concurrent builds
    build_seconds[name] = time.perf_counter() - t0
    return so_path


def load(name: str, defines: tuple = ()) -> ctypes.CDLL:
    """Build (if needed) and dlopen ``csrc/<name>.cu``; cached per process."""
    key = name if not defines else f"{name}[{','.join(defines)}]"
    lib = _loaded.get(key)
    if lib is None:
        lib = _loaded[key] = ctypes.CDLL(str(build(name, defines=defines)))
    return lib


def build_variant(name: str, subs, tag: str, tree: Path | None = None) -> Path:
    """Compile a copy of ``csrc/<name>.cu`` (of the checkout ``tree``, else
    this one) with each ``(old, new)`` of ``subs`` substituted, old found
    exactly once in the source or, failing that, in one ``csrc/*.cuh`` header
    (copied beside it, so the copy's include wins), into this checkout's
    ``_build/variants/<tag>/``; never into ``csrc/``, and nothing is written
    under ``tree``. For mutants and timing variants. → the library's path."""
    csrc = CSRC if tree is None else Path(tree) / "pregen_pde_tpu_torch" / "csrc"
    out = BUILD_DIR / "variants" / tag
    shutil.rmtree(out, ignore_errors=True)  # no header copy of an earlier variant
    out.mkdir(parents=True)
    files = {p.name: p.read_text() for p in [csrc / f"{name}.cu", *sorted(csrc.glob("*.cuh"))]}
    changed = {f"{name}.cu"}
    for old, new in subs:
        hits = [f for f, text in files.items() if text.count(old) == 1]
        if len(hits) != 1:
            raise RuntimeError(f"variant {tag}: {old!r} is not in exactly one of "
                               f"{sorted(files)} exactly once")
        files[hits[0]] = files[hits[0]].replace(old, new)
        changed.add(hits[0])
    for f in changed:
        (out / f).write_text(files[f])
    nvcc = find_nvcc()
    if nvcc is None:
        raise RuntimeError(f"cannot build variant {tag!r}: nvcc not found")
    so = out / "lib.so"
    proc = subprocess.run([nvcc, *NVCC_FLAGS, "-I", str(csrc), "-o", str(so),
                           str(out / f"{name}.cu")], capture_output=True, text=True)
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed building variant {tag!r}:\n{proc.stderr}")
    return so
