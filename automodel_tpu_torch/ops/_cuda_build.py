"""Build the port's CUDA C++ kernels with ``nvcc`` and load them with
``ctypes``.

Each ``csrc/<name>.cu`` has a plain C interface and compiles on its own into
``_build/lib<name>-<hash>.so`` (the hash is of the source and of every
``csrc`` header it includes, so an edited source or header never loads a
stale library), with ptxas's report of each kernel's
registers, spills and shared memory (``-Xptxas -v``) kept beside it as
``lib<name>-<hash>.log`` and read by ``ptxas_usage``. ``build`` starts one
``nvcc`` per source at once and waits for all of them; ``load`` builds on
first use. Nothing is built or imported when this module is imported.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import re
import shutil
import subprocess
from pathlib import Path

PKG_DIR = Path(__file__).resolve().parent.parent
CSRC_DIR = PKG_DIR / "csrc"
BUILD_DIR = PKG_DIR / "_build"
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)

_loaded: dict[str, ctypes.CDLL] = {}


def nvcc_path() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    default = "/usr/local/cuda/bin/nvcc"
    if os.path.exists(default):
        return default
    raise RuntimeError(
        "nvcc not found (PATH or /usr/local/cuda/bin): the port's CUDA "
        "kernels are built from csrc/ at first use"
    )


_INCLUDE = re.compile(r'^\s*#\s*include\s+"([^"]+)"', re.MULTILINE)


def _sources(name: str) -> list[Path]:
    """``csrc/<name>.cu`` and every ``csrc`` file it includes with quotes,
    directly or through another, each once, in the order they are met."""
    found: list[Path] = []
    todo = [CSRC_DIR / f"{name}.cu"]
    while todo:
        path = todo.pop(0)
        if path in found:
            continue
        found.append(path)
        todo += [CSRC_DIR / inc for inc in _INCLUDE.findall(path.read_text()) if (CSRC_DIR / inc).is_file()]
    return found


def _lib_path(name: str) -> Path:
    h = hashlib.sha256()
    for path in _sources(name):
        h.update(path.name.encode() + b"\0" + path.read_bytes())
    return BUILD_DIR / f"lib{name}-{h.hexdigest()[:16]}.so"


def build(names: list[str]) -> dict[str, Path]:
    """Compile every named source that has no library yet, all ``nvcc``
    processes started together. Raises with the compiler's output when one
    fails. → {name: library path}."""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    procs = {}
    out = {}
    for name in names:
        lib = _lib_path(name)
        out[name] = lib
        if lib.exists():
            continue
        tmp = lib.with_suffix(f".{os.getpid()}.tmp")
        cmd = [nvcc_path(), *NVCC_FLAGS, "-o", str(tmp), str(CSRC_DIR / f"{name}.cu")]
        procs[name] = (
            subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True),
            tmp,
            lib,
        )
    failures = []
    for name, (proc, tmp, lib) in procs.items():
        log, _ = proc.communicate()
        if proc.returncode != 0:
            failures.append(f"nvcc {name}.cu failed (rc {proc.returncode}):\n{log}")
            continue
        lib.with_suffix(".log").write_text(log)
        os.replace(tmp, lib)
    if failures:
        raise RuntimeError("\n".join(failures))
    return out


def load(name: str) -> ctypes.CDLL:
    """The loaded library for ``csrc/<name>.cu``, built on first use."""
    lib = _loaded.get(name)
    if lib is None:
        path = build([name])[name]
        lib = _loaded[name] = ctypes.CDLL(str(path))
    return lib


_ENTRY = re.compile(r"Compiling entry function '(\w+)'")
_SPILLS = re.compile(r"(\d+) bytes spill stores, (\d+) bytes spill loads")
_USED = re.compile(r"Used (\d+) registers")


def _kernel_name(mangled: str) -> str:
    """``..16flash_fwd_kernelILi256ELb1EE..`` → ``flash_fwd_kernel<256, 1>``:
    the length-prefixed name ending in ``_kernel`` that opens a template
    argument list, with its integer and bool arguments, or that ends the
    nested name (``..14gmm_act_kernelE..`` → ``gmm_act_kernel``); the
    mangled name as it is when there is none."""
    for m in re.finditer(r"\d+", mangled):
        for i in range(m.start(), m.end()):  # the length's digits may follow other digits
            n, end = int(mangled[i:m.end()]), m.end()
            name = mangled[end:end + n]
            if len(name) != n or not name.endswith("_kernel"):
                continue
            after = mangled[end + n:]
            if after.startswith("I"):
                args = re.match(r"I((?:L[ib]\d+E)+)E", after)
                if args:
                    return f"{name}<{', '.join(re.findall(r'L[ib](\d+)E', args.group(1)))}>"
            elif after.startswith("E"):
                return name
    return mangled


def parse_ptxas(log: str) -> list[dict]:
    """ptxas's ``-v`` report → one dict per kernel: ``kernel`` (its template
    arguments spelled out where it has any), ``registers`` a thread,
    ``spill_stores`` and ``spill_loads`` in bytes."""
    out: list[dict] = []
    for line in log.splitlines():
        if m := _ENTRY.search(line):
            out.append(dict(kernel=_kernel_name(m.group(1))))
        elif out and (m := _SPILLS.search(line)):
            out[-1].update(spill_stores=int(m.group(1)), spill_loads=int(m.group(2)))
        elif out and (m := _USED.search(line)):
            out[-1]["registers"] = int(m.group(1))
    return out


def parse_sass_registers(sass: str) -> dict:
    """``cuobjdump -sass`` output → {kernel: {"registers": one past the
    highest register index its code names, "setmaxnreg_dec" / "_inc": the
    counts its ``setmaxnreg.dec`` / ``.inc`` set, in order}}: where
    warpgroups raise their count with setmaxnreg, ``registers`` is more
    than ptxas's count at entry."""
    out = {}
    for fn in re.split(r"\n\s*Function : ", sass)[1:]:
        regs = [int(r) for r in re.findall(r"\bR(\d+)\b", fn)]
        setmax = re.findall(r"USETMAXREG\.(DEALLOC|TRY_ALLOC|ALLOC)\S*\s+(?:\w+,\s*)?(0x[0-9a-f]+|\d+)", fn)
        out[_kernel_name(fn.split("\n", 1)[0].strip())] = dict(
            registers=max(regs, default=-1) + 1,
            setmaxnreg_dec=sorted({int(v, 0) for kind, v in setmax if kind == "DEALLOC"}),
            setmaxnreg_inc=sorted({int(v, 0) for kind, v in setmax if kind != "DEALLOC"}),
        )
    return out


def sass_registers(name: str) -> dict:
    """``parse_sass_registers`` of the library built from ``csrc/<name>.cu``
    (building it first if need be); empty when the toolkit has no
    cuobjdump."""
    tool = Path(nvcc_path()).with_name("cuobjdump")
    if not tool.exists():
        return {}
    lib = build([name])[name]
    return parse_sass_registers(subprocess.run([str(tool), "-sass", str(lib)], capture_output=True, text=True).stdout)


def ptxas_usage(name: str) -> list[dict]:
    """``parse_ptxas`` of the report kept when ``csrc/<name>.cu`` was built
    (building it first if need be)."""
    return parse_ptxas(build([name])[name].with_suffix(".log").read_text())
