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


# Set by ``diagnostics.debug_nans`` for the span of its block: called with
# each kernel op's name and outputs after the op runs.
nan_check: Optional[Callable] = None


def reset_launch_counts() -> None:
    for k in KERNELS:
        k.launches = 0


_P, _I, _D, _LL = ctypes.c_void_p, ctypes.c_int, ctypes.c_double, ctypes.c_longlong
_SIGNATURES = {
    "bft_error_string": ([_I], ctypes.c_char_p),
    "bft_smem_optin": ([_I], _I),
    "bft_ekf_update_f32": ([_P] * 9 + [_I, _I, _I, _D, _P], _I),
    "bft_ekf_update_f64": ([_P] * 9 + [_I, _I, _I, _D, _P], _I),
    "bft_ekf_predict_cov_f32": ([_P] * 5 + [_I, _I, _I, _P], _I),
    "bft_ekf_predict_cov_f64": ([_P] * 5 + [_I, _I, _I, _P], _I),
    "bft_ekf_update_tiled_scratch_elems": ([_I, _I], _LL),
    "bft_ekf_predict_cov_tiled_scratch_elems": ([_I, _I], _LL),
    "bft_ekf_update_tiled_f32": ([_P] * 10 + [_I, _I, _I, _D, _P], _I),
    "bft_ekf_update_tiled_f64": ([_P] * 10 + [_I, _I, _I, _D, _P], _I),
    "bft_ekf_predict_cov_tiled_f32": ([_P] * 6 + [_I, _I, _I, _P], _I),
    "bft_ekf_predict_cov_tiled_f64": ([_P] * 6 + [_I, _I, _I, _P], _I),
    "bft_bank_update_f32": ([_P] * 9 + [_I, _I, _I, _D, _P], _I),
    "bft_bank_update_f64": ([_P] * 9 + [_I, _I, _I, _D, _P], _I),
    "bft_bank_predict_cov_f32": ([_P] * 5 + [_I, _I, _I, _P], _I),
    "bft_bank_predict_cov_f64": ([_P] * 5 + [_I, _I, _I, _P], _I),
    "bft_ut_sigma_tiled_scratch_elems": ([_I] * 3, _LL),
    "bft_ut_sigma_aug_tiled_scratch_elems": ([_I] * 4, _LL),
    "bft_ut_update_tiled_scratch_elems": ([_I, _I, _I], _LL),
    "bft_ut_predict_tiled_scratch_elems": ([_I, _I, _I], _LL),
    "bft_ut_sigma_f32": ([_P] * 3 + [_I, _I, _D, _I, _P], _I),
    "bft_ut_sigma_f64": ([_P] * 3 + [_I, _I, _D, _I, _P], _I),
    "bft_ut_sigma_aug_f32": ([_P] * 6 + [_I, _I, _I, _D, _I, _P], _I),
    "bft_ut_sigma_aug_f64": ([_P] * 6 + [_I, _I, _I, _D, _I, _P], _I),
    "bft_ut_sigma_tiled_f32": ([_P] * 4 + [_I, _I, _D, _I, _P], _I),
    "bft_ut_sigma_tiled_f64": ([_P] * 4 + [_I, _I, _D, _I, _P], _I),
    "bft_ut_sigma_aug_tiled_f32": ([_P] * 6 + [_I, _I, _I, _D, _I, _P], _I),
    "bft_ut_sigma_aug_tiled_f64": ([_P] * 6 + [_I, _I, _I, _D, _I, _P], _I),
    "bft_ut_update_f32": ([_P] * 11 + [_I] * 5 + [_D, _D, _P], _I),
    "bft_ut_update_f64": ([_P] * 11 + [_I] * 5 + [_D, _D, _P], _I),
    "bft_ut_predict_f32": ([_P] * 5 + [_I, _I, _I, _D, _D, _D, _P], _I),
    "bft_ut_predict_f64": ([_P] * 5 + [_I, _I, _I, _D, _D, _D, _P], _I),
    "bft_ut_update_tiled_f32": ([_P] * 12 + [_I] * 5 + [_D, _D, _P], _I),
    "bft_ut_update_tiled_f64": ([_P] * 12 + [_I] * 5 + [_D, _D, _P], _I),
    "bft_ut_predict_tiled_f32": ([_P] * 6 + [_I, _I, _I, _D, _D, _D, _P], _I),
    "bft_ut_predict_tiled_f64": ([_P] * 6 + [_I, _I, _I, _D, _D, _D, _P], _I),
    "bft_resample_parents_i32": ([_P, _P, _I, _I, _P], _I),
    "bft_bank_combine_f32": ([_P] * 15 + [_I] * 4 + [_P], _I),
    "bft_bank_combine_f64": ([_P] * 15 + [_I] * 4 + [_P], _I),
    "bft_bank_smoother_elements_f32": ([_P] * 8 + [_I] * 3 + [_P], _I),
    "bft_bank_smoother_elements_f64": ([_P] * 8 + [_I] * 3 + [_P], _I),
    "bft_bank_smoother_combine_f32": ([_P] * 9 + [_I] * 4 + [_P], _I),
    "bft_bank_smoother_combine_f64": ([_P] * 9 + [_I] * 4 + [_P], _I),
    "bft_block_scratch_elems": ([_I] * 4, _LL),
    "bft_block_combine_f32": ([_P] * 16 + [_I] * 6 + [_P], _I),
    "bft_block_combine_f64": ([_P] * 16 + [_I] * 6 + [_P], _I),
    "bft_block_smoother_elements_f32": ([_P] * 9 + [_I] * 5 + [_P], _I),
    "bft_block_smoother_elements_f64": ([_P] * 9 + [_I] * 5 + [_P], _I),
    "bft_block_smoother_combine_f32": ([_P] * 10 + [_I] * 6 + [_P], _I),
    "bft_block_smoother_combine_f64": ([_P] * 10 + [_I] * 6 + [_P], _I),
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
    """Compile every ``csrc/*.cu`` to an object, one nvcc per source, all
    started together, then link them into ``out``. Returns nvcc's messages
    (register and spill counts from ptxas)."""
    nvcc = _nvcc()
    tmp = out.parent / f"tmp.{os.getpid()}"
    tmp.mkdir(parents=True, exist_ok=True)
    srcs = sorted(_CSRC.glob("*.cu"))
    objs = [str(tmp / (src.stem + ".o")) for src in srcs]
    procs = [subprocess.Popen([nvcc, *NVCC_FLAGS, "-c", str(src), "-o", obj],
                              stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                              text=True)
             for src, obj in zip(srcs, objs)]
    log = []
    failed = []
    for src, proc in zip(srcs, procs):
        out_text, _ = proc.communicate()
        log.append(out_text)
        if proc.returncode != 0:
            failed.append(f"nvcc failed on {src.name}:\n{out_text}")
    if failed:
        raise RuntimeError("\n".join(failed))
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


_OPTIN = {}


# Room the per-element kernels keep for their static shared memory
# (``kStaticSmemSlack`` of csrc/common.cuh).
SMEM_SLACK = 256


def fits_smem(elems: int, itemsize: int, smem_optin: int) -> bool:
    """Whether a per-element workspace of ``elems`` elements fits in a
    block's shared memory beside the static slack, under an opt-in of
    ``smem_optin`` bytes: the rule between a per-element kernel and its
    tiled variant."""
    return elems * itemsize + SMEM_SLACK <= smem_optin


def smem_optin(device: torch.device) -> int:
    """The CUDA device's shared-memory opt-in per block, in bytes: the
    bound on a per-element kernel's workspace."""
    index = torch.device(device).index or 0
    if index not in _OPTIN:
        optin = load().bft_smem_optin(index)
        if optin < 0:
            raise RuntimeError(f"device {index}: shared-memory opt-in query "
                               "failed")
        _OPTIN[index] = optin
    return _OPTIN[index]


_SMS = {}


def sm_count(device: torch.device) -> int:
    """The CUDA device's count of streaming multiprocessors (132 on an
    H100 SXM)."""
    index = torch.device(device).index or 0
    if index not in _SMS:
        _SMS[index] = torch.cuda.get_device_properties(
            index).multi_processor_count
    return _SMS[index]


def ptr(t) -> Optional[int]:
    return None if t is None else t.data_ptr()


def scratch(elems: int, kernel: Kernel, batch: int, like: torch.Tensor):
    """The global scratch a launcher asked for: ``elems`` per block (0 when
    its workspace fits in shared memory, negative on a failed device
    query), for ``batch`` blocks, in ``like``'s dtype and device."""
    if elems < 0:
        raise RuntimeError(f"{kernel.name}: device attribute query failed")
    return like.new_empty(batch * elems) if elems else None


_SUFFIXES = {torch.float32: "f32", torch.float64: "f64", torch.int32: "i32"}


def symbol(kernel: Kernel, t) -> Callable:
    """The C entry point of ``kernel`` for ``t``'s dtype (f32, f64, or i32
    for the integer kernel K5)."""
    return getattr(load(), f"{kernel.name}_{_SUFFIXES[t.dtype]}")


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
            out = run(*tensors, *static)
            if nan_check is not None:
                nan_check(getattr(launch, "__name__", "kernel_op"), out)
            return out

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
           "check", "check_operands", "kernel_op", "scratch", "smem_optin",
           "fits_smem", "SMEM_SLACK",
           "BUILD_DIR"]
