"""Build the C ABI of the port: librt64tpu_torch.so (the embedding shim,
rt64_abi.cpp) and the two sample hosts, with g++ and python-config as
rt64tpu/abi/Makefile builds the JAX package's:

    python3 -m rt64tpu_torch.abi.build      # builds, prints the paths

The outputs go to build/rt64tpu_torch_abi/<hash>/ under the repository
root (gitignored), at first use, keyed by a hash of the sources, the
compiler flags, the interpreter and the root, so an edit rebuilds and a
second call reuses. The shim embeds the interpreter that built it
(sys.executable) and imports the package from this checkout: both are
compile-time definitions. A failed build raises with the compiler's
output.

run_host runs a built host headless on RT64TPU_VIEW_WIDTH x
RT64TPU_VIEW_HEIGHT; the library draws on the CUDA card unless the
environment says RT64TPU_TORCH_DEVICE=cpu (see bridge.py).
"""

from __future__ import annotations

import hashlib
import json
import os
import shutil
import subprocess
import sys
import time
from typing import NamedTuple, Optional

ABI_DIR = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(os.path.dirname(ABI_DIR))
BUILD_DIR = os.path.join(ROOT, "build", "rt64tpu_torch_abi")
LIBRARY = "librt64tpu_torch.so"
HOSTS = ("sample_host", "sample_host_dl")
SOURCES = ("rt64_tpu.h", "rt64_abi.cpp") + tuple(f"{h}.cpp" for h in HOSTS)
CXXFLAGS = ["-O2", "-fPIC", "-std=c++17", "-Wall"]


class AbiBuild(NamedTuple):
    directory: str
    library: str
    sample_host: str
    sample_host_dl: str
    seconds: float  # 0.0 when an earlier build was reused
    log: str


def python_config() -> str:
    """The python-config of this interpreter's version."""
    ver = f"{sys.version_info.major}.{sys.version_info.minor}"
    for name in (f"python{ver}-config", "python3-config"):
        path = shutil.which(name)
        if path:
            return path
    raise RuntimeError(f"no python{ver}-config or python3-config on PATH: "
                       "the C ABI embeds Python and needs its build flags")


def compiler() -> str:
    path = shutil.which(os.environ.get("CXX", "g++"))
    if path is None:
        raise RuntimeError("no C++ compiler (g++ or $CXX) on PATH")
    return path


def _run(cmd):
    out = subprocess.run(cmd, capture_output=True, text=True)
    if out.returncode != 0:
        raise RuntimeError(f"{' '.join(cmd)} failed ({out.returncode}):\n"
                           f"{out.stdout}{out.stderr}")
    return out.stdout


def _commands(out_dir: str):
    """{output name: g++ command line} for the library and both hosts."""
    config = python_config()
    includes = _run([config, "--includes"]).split()
    ldflags = _run([config, "--ldflags", "--embed"]).split()
    # libpython found at run time where the flags found it at link time.
    rpaths = [f"-Wl,-rpath,{f[2:]}" for f in ldflags if f.startswith("-L")]
    defines = [f'-DRT64TPU_TORCH_PYTHON="{sys.executable}"',
               f'-DRT64TPU_TORCH_ROOT="{ROOT}"']
    cxx = [compiler()] + CXXFLAGS
    src = lambda name: os.path.join(ABI_DIR, name)
    out = lambda name: os.path.join(out_dir, name)
    return {
        LIBRARY: cxx + includes + defines + [
            "-shared", "-o", out(LIBRARY), src("rt64_abi.cpp")] + ldflags + rpaths,
        "sample_host": cxx + [
            "-o", out("sample_host"), src("sample_host.cpp"), f"-L{out_dir}",
            "-lrt64tpu_torch", "-Wl,-rpath,$ORIGIN"],
        # Runtime binding: no -lrt64tpu_torch; RT64_LoadLibrary resolves it.
        "sample_host_dl": cxx + [
            "-o", out("sample_host_dl"), src("sample_host_dl.cpp"), "-ldl",
            "-Wl,-rpath,$ORIGIN"],
    }


def _digest(commands) -> str:
    sha = hashlib.sha256(json.dumps(
        [commands[k] for k in sorted(commands)]).encode())
    for name in SOURCES:
        with open(os.path.join(ABI_DIR, name), "rb") as f:
            sha.update(name.encode() + b"\0" + f.read() + b"\0")
    return sha.hexdigest()[:16]


def build(out_dir: Optional[str] = None) -> AbiBuild:
    """Build (or reuse) the library and both hosts. out_dir: where to
    build (always builds there); None: the cached build directory."""
    if out_dir is None:
        probe = _commands("@")
        out_dir = os.path.join(BUILD_DIR, _digest(probe))
        if all(os.path.exists(os.path.join(out_dir, n))
               for n in (LIBRARY,) + HOSTS):
            return _result(out_dir, 0.0, "")
    os.makedirs(out_dir, exist_ok=True)
    commands = _commands(out_dir)
    t0 = time.perf_counter()
    # The library and the runtime-bound host at once, then the host that
    # links the library.
    first = {name: subprocess.Popen(commands[name], stdout=subprocess.PIPE,
                                    stderr=subprocess.STDOUT, text=True)
             for name in (LIBRARY, "sample_host_dl")}
    logs = {name: proc.communicate()[0] for name, proc in first.items()}
    failed = [n for n, p in first.items() if p.returncode != 0]
    if not failed:
        linked = subprocess.run(commands["sample_host"], capture_output=True,
                                text=True)
        logs["sample_host"] = linked.stdout + linked.stderr
        if linked.returncode != 0:
            failed.append("sample_host")
    log = "".join(f"$ {' '.join(commands[n])}\n{logs[n]}" for n in logs)
    if failed:
        raise RuntimeError(f"the C ABI build failed on {failed}:\n{log}")
    return _result(out_dir, time.perf_counter() - t0, log)


def _result(out_dir, seconds, log) -> AbiBuild:
    path = lambda name: os.path.join(out_dir, name)
    return AbiBuild(out_dir, path(LIBRARY), path("sample_host"),
                    path("sample_host_dl"), seconds, log)


def run_host(binary: str, ppm_path: str, width: int, height: int,
             env: Optional[dict] = None, timeout: float = 600.0):
    """Run a sample host headless at width x height, writing ppm_path:
    the CompletedProcess. env: variables added to this process's (for
    example RT64TPU_TORCH_DEVICE, RT64TPU_LIBRARY)."""
    full = dict(os.environ, RT64TPU_VIEW_WIDTH=str(width),
                RT64TPU_VIEW_HEIGHT=str(height), **(env or {}))
    return subprocess.run([binary, ppm_path], env=full, capture_output=True,
                          text=True, timeout=timeout)


if __name__ == "__main__":
    print(json.dumps(build()._asdict(), indent=1))
