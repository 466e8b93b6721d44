"""Build and load the hand-written CUDA kernels.

The ``csrc/*.cu`` sources are compiled at first use with ``nvcc`` for
Hopper (``sm_90a``) into one shared library with a plain C interface,
loaded with :mod:`ctypes`. The library lands in
``build/bayesianfiltering_tpu_torch/<hash>/`` at the repository root, keyed
by a hash of the sources and flags, so an edited kernel rebuilds and an
unchanged one is reused. Nothing here runs at import time: the CPU paths of
the package never touch the compiler.

Each kernel has a :class:`Kernel` record whose ``launches`` count its
wrapper increments, once per launch, so a run can show that it went
through the kernel.
"""
from __future__ import annotations

import ctypes
import dataclasses
import hashlib
import os
import subprocess
import time
from pathlib import Path
from typing import Callable, List, Optional

import torch

_PKG_DIR = Path(__file__).resolve().parent
_CSRC = _PKG_DIR / "csrc"
BUILD_DIR = _PKG_DIR.parent / "build" / "bayesianfiltering_tpu_torch"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-Xcompiler", "-fPIC", "-Xptxas", "-v")


@dataclasses.dataclass
class Kernel:
    """One CUDA kernel of the package: its C symbol stem, source, the TPU
    kernel it replaces, and how many times its wrapper has launched it."""

    name: str
    source: str
    replaces: str
    launches: int = 0


KERNELS: List[Kernel] = []


def register(name: str, source: str, replaces: str) -> Kernel:
    k = Kernel(name, source, replaces)
    KERNELS.append(k)
    return k


def reset_launch_counts() -> None:
    for k in KERNELS:
        k.launches = 0


_P, _I, _D, _LL = ctypes.c_void_p, ctypes.c_int, ctypes.c_double, ctypes.c_longlong
_SIGNATURES = {
    "bft_error_string": ([_I], ctypes.c_char_p),
    "bft_ekf_update_scratch_elems": ([_I, _I, _I, _I], _LL),
    "bft_ekf_predict_cov_scratch_elems": ([_I, _I, _I, _I], _LL),
    "bft_ekf_update_f32": ([_P] * 10 + [_I, _I, _I, _D, _P], _I),
    "bft_ekf_update_f64": ([_P] * 10 + [_I, _I, _I, _D, _P], _I),
    "bft_ekf_predict_cov_f32": ([_P] * 6 + [_I, _I, _I, _P], _I),
    "bft_ekf_predict_cov_f64": ([_P] * 6 + [_I, _I, _I, _P], _I),
    "bft_bank_update_f32": ([_P] * 9 + [_I, _I, _I, _D, _P], _I),
    "bft_bank_update_f64": ([_P] * 9 + [_I, _I, _I, _D, _P], _I),
    "bft_bank_predict_cov_f32": ([_P] * 5 + [_I, _I, _I, _P], _I),
    "bft_bank_predict_cov_f64": ([_P] * 5 + [_I, _I, _I, _P], _I),
}

_LIB: Optional[ctypes.CDLL] = None
build_seconds: Optional[float] = None
build_log: str = ""


def _sources() -> List[Path]:
    return sorted(_CSRC.glob("*.cu")) + sorted(_CSRC.glob("*.cuh"))


def _digest() -> str:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for src in _sources():
        h.update(src.name.encode())
        h.update(src.read_bytes())
    return h.hexdigest()[:16]


def _nvcc() -> str:
    from torch.utils.cpp_extension import CUDA_HOME  # finds the toolkit

    if CUDA_HOME is None:
        raise RuntimeError("no CUDA toolkit found (CUDA_HOME is unset and "
                           "nvcc is not on PATH); cannot build the kernels")
    return str(Path(CUDA_HOME) / "bin" / "nvcc")


def _compile(out: Path) -> str:
    """Compile every ``csrc/*.cu`` to an object, link them into ``out``.
    Returns nvcc's messages (register and spill counts from ptxas)."""
    nvcc = _nvcc()
    tmp = out.parent / f"tmp.{os.getpid()}"
    tmp.mkdir(parents=True, exist_ok=True)
    log = []
    objs = []
    for src in sorted(_CSRC.glob("*.cu")):
        obj = tmp / (src.stem + ".o")
        r = subprocess.run([nvcc, *NVCC_FLAGS, "-c", str(src), "-o", str(obj)],
                           capture_output=True, text=True)
        log.append(r.stdout + r.stderr)
        if r.returncode != 0:
            raise RuntimeError(f"nvcc failed on {src.name}:\n{log[-1]}")
        objs.append(str(obj))
    lib = tmp / out.name
    r = subprocess.run([nvcc, "-shared", "-o", str(lib), *objs],
                       capture_output=True, text=True)
    log.append(r.stdout + r.stderr)
    if r.returncode != 0:
        raise RuntimeError(f"nvcc link failed:\n{log[-1]}")
    os.replace(lib, out)  # atomic: a concurrent build never sees a partial .so
    for p in tmp.iterdir():
        p.unlink()
    tmp.rmdir()
    return "".join(log)


def load() -> ctypes.CDLL:
    """The kernel library, built on first call. Raises if it cannot be
    built or loaded; there is no fallback."""
    global _LIB, build_seconds, build_log
    if _LIB is not None:
        return _LIB
    out = BUILD_DIR / _digest() / "libbft_kernels.so"
    t0 = time.perf_counter()
    if not out.exists():
        out.parent.mkdir(parents=True, exist_ok=True)
        build_log = _compile(out)
    lib = ctypes.CDLL(str(out))
    for fn, (argtypes, restype) in _SIGNATURES.items():
        getattr(lib, fn).argtypes = argtypes
        getattr(lib, fn).restype = restype
    build_seconds = time.perf_counter() - t0
    _LIB = lib
    return lib


def check(err: int, kernel: Kernel) -> None:
    """Raise if a launcher returned a CUDA error code."""
    if err != 0:
        msg = load().bft_error_string(err).decode()
        raise RuntimeError(f"{kernel.name} launch failed: {msg} ({err})")


def ptr(t) -> Optional[int]:
    return None if t is None else t.data_ptr()


def symbol(kernel: Kernel, t) -> Callable:
    """The C entry point of ``kernel`` for ``t``'s dtype (f32 or f64)."""
    suffix = "f32" if t.dtype == torch.float32 else "f64"
    return getattr(load(), f"{kernel.name}_{suffix}")


def check_operands(kernel: Kernel, *operands) -> None:
    """Validate ``(tensor, shape)`` pairs before their pointers go to C:
    one CUDA device, float32 or float64 throughout, exact shapes,
    contiguous memory."""
    first = operands[0][0]
    if not first.is_cuda:
        raise ValueError(f"{kernel.name}: operands must be CUDA tensors")
    if first.dtype not in (torch.float32, torch.float64):
        raise TypeError(f"{kernel.name}: dtype {first.dtype} is not "
                        "float32 or float64")
    for t, shape in operands:
        if t.device != first.device or t.dtype != first.dtype:
            raise TypeError(f"{kernel.name}: operands mix devices or dtypes "
                            f"({t.device}/{t.dtype} vs "
                            f"{first.device}/{first.dtype})")
        if tuple(t.shape) != tuple(shape):
            raise ValueError(f"{kernel.name}: operand of shape "
                             f"{tuple(t.shape)}, expected {tuple(shape)}")
        if not t.is_contiguous():
            raise ValueError(f"{kernel.name}: operands must be contiguous")


def kernel_op(plain: Callable, launch: Callable, num_tensors: int) -> Callable:
    """Bind a CUDA launcher and its plain PyTorch twin as one differentiable
    op: the forward runs ``launch`` on CUDA tensors and ``plain`` on CPU
    tensors; the backward re-runs ``plain`` under autograd (the kernels are
    forward-only, as the TPU kernels under their ``custom_vjp`` are).
    Arguments past the first ``num_tensors`` are static (not differentiated).
    """
    class Op(torch.autograd.Function):
        @staticmethod
        def forward(ctx, *args):
            tensors, static = args[:num_tensors], args[num_tensors:]
            ctx.static = static
            ctx.save_for_backward(*tensors)
            run = launch if tensors[0].is_cuda else plain
            return run(*tensors, *static)

        @staticmethod
        def backward(ctx, *cts):
            needs = ctx.needs_input_grad[:num_tensors]
            with torch.enable_grad():
                xs = [t.detach().requires_grad_(n)
                      for t, n in zip(ctx.saved_tensors, needs)]
                outs = plain(*xs, *ctx.static)
                outs = outs if isinstance(outs, tuple) else (outs,)
                pairs = [(o, c) for o, c in zip(outs, cts)
                         if c is not None and o.requires_grad]
                wrt = [x for x in xs if x.requires_grad]
                grads = iter(torch.autograd.grad(
                    [o for o, _ in pairs], wrt, [c for _, c in pairs],
                    allow_unused=True))
            return (*(next(grads) if n else None for n in needs),
                    *(None,) * len(ctx.static))

    return Op.apply


__all__ = ["Kernel", "KERNELS", "register", "reset_launch_counts", "load",
           "check", "check_operands", "kernel_op", "BUILD_DIR"]
