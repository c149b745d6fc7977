"""Profiling probes on the card: the counterparts of the Pallas probes in
``scripts/prof/``, as hand-written CUDA kernels (``csrc/probe_*.cu``).

* :mod:`.lut` — chained and wide table lookups with the table in shared
  memory (plain or one copy per bank), in global memory through L1 or L2
  only, or in registers read with ``__shfl_sync`` (P1, P2, P3, P6's
  ``f_gather3``);
* :mod:`.mma_lut` — the one-hot lookup on the tensor cores (P6's
  ``f_onehot``, P1's ``k_onehot``);
* :mod:`.latency` — dependent ALU and gather steps, swept over occupancy
  (P4);
* :mod:`.pack_ablate` — the port's pack loop with parts removed (P5);
* :mod:`.decode_ablate` — the port's two parallel decode loops with their
  stores swapped (the question of ``scripts/prof/prof_decode_parts.py``).

Each module has its kernels' wrappers (the plain PyTorch version for a CPU
tensor, the kernel for a CUDA tensor, a launch count), its scripts' inputs
regenerated from their seeds in their draw order, a ``run`` that checks
every form against the plain version at the scripts' shapes and times it
at a shape that fills the card, and a ``main``:

    python -m tpu_huffman_torch.prof.lut   # or .mma_lut, .latency, .pack_ablate, .decode_ablate

Without a CUDA device ``run`` and ``main`` raise. This module holds what
they share: the device checks, the launch shape, the comparison with the
plain version, and the timers (CUDA events; for the kernels, calls queued
behind a sleep kernel so that the host's time does not count; warm-up,
median of 11; the slope between two round or step counts, which takes the
launch out). ``chip_smoke.py`` times its wrappers and plain versions with
the same :func:`median_ms`. :mod:`.sass` reads a built kernel's main loop
in SASS (``cuobjdump``): its instructions a shared-memory load, by opcode.
"""

from __future__ import annotations

import statistics
import subprocess

import torch

REPS = 11  # timed samples per median
CALLS = 5  # back-to-back calls per sample
FILL_ELEMENTS = 8 << 20  # one thread an element at 2048 threads on 132 SMs, 31 times over
WARPS_PER_SM = (1, 8, 64)  # the occupancy sweep
MAX_THREADS_PER_SM = 2048
SLEEP_CYCLES = 4_000_000  # ~2 ms at the H100's clock: the host queues a sample's calls meanwhile


def is_cuda(t: torch.Tensor) -> bool:
    """True for a CUDA tensor (launch the kernel), False for a CPU one (run
    the plain version); any other device raises."""
    if t.device.type == "cuda":
        return True
    if t.device.type == "cpu":
        return False
    raise ValueError(f"unsupported device {t.device}")


def require_cuda() -> torch.device:
    """The card; raises without one (a probe has no CPU fallback)."""
    if not torch.cuda.is_available():
        raise RuntimeError("the probes need a CUDA device: torch.cuda.is_available() is False")
    return torch.device("cuda")


def on_card(dev: torch.device | None = None) -> torch.device:
    """The device a probe runs on: the given CUDA device, or the card;
    raises for anything else."""
    dev = dev or require_cuda()
    if dev.type != "cuda":
        raise RuntimeError(f"the probes run on a CUDA device, not {dev}")
    return dev


def card() -> str:
    """The card's name and power limit, as nvidia-smi prints them."""
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip()


def grid(n: int, block: int, dev: torch.device) -> int:
    """Blocks for n elements at one thread an element, capped at one full
    wave (the kernels loop over the rest)."""
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    return max(1, min(-(-n // block), sms * (MAX_THREADS_PER_SM // block)))


def sweep_shape(warps_per_sm: int, dev: torch.device) -> tuple[int, int]:
    """(elements, block) that put warps_per_sm warps on every SM in one
    wave: blocks of 32, 256 or 1024 threads, one or two to an SM."""
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    block = min(32 * warps_per_sm, 1024 if warps_per_sm > 8 else 256)
    return sms * warps_per_sm * 32, block


def one_wave(dev: torch.device) -> int:
    """Elements that give every SM 2048 threads once: the smallest shape
    that fills the card (270,336 on an H100's 132 SMs)."""
    return sweep_shape(max(WARPS_PER_SM), dev)[0]


def median_ms(fn) -> float:
    """Device time of one fn() call, wrapper and host gaps included: the
    median over REPS samples, each timed by CUDA events around CALLS
    back-to-back calls, after one warm-up call."""
    fn()
    times = []
    for _ in range(REPS):
        start = torch.cuda.Event(enable_timing=True)
        stop = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(CALLS):
            fn()
        stop.record()
        stop.synchronize()
        times.append(start.elapsed_time(stop) / CALLS)
    return statistics.median(times)


def kernel_ms(calls: dict) -> dict:
    """Device time of each call's kernels, back to back: the median over
    REPS samples of CALLS calls each. A wrapper spends tens of microseconds
    of host time a call, as long as some of these kernels run, so each
    sample first queues a sleep kernel long enough for the host to queue
    all its calls behind it; the events then time the card alone (every
    kernel the call launches, a fill of its output included). Returns
    {label: ms a call}.
    """
    times = {}
    for label, fn in calls.items():
        fn()
        samples = []
        for _ in range(REPS):
            start = torch.cuda.Event(enable_timing=True)
            stop = torch.cuda.Event(enable_timing=True)
            torch.cuda._sleep(SLEEP_CYCLES)
            start.record()
            for _ in range(CALLS):
                fn()
            stop.record()
            stop.synchronize()
            samples.append(start.elapsed_time(stop) / CALLS)
        times[label] = statistics.median(samples)
    return times


def slope_ns(t_lo_ms: float, t_hi_ms: float, steps: int) -> float:
    """ns a round (or step): the time difference between two round counts
    over their difference, which takes the launch out."""
    return (t_hi_ms - t_lo_ms) * 1e6 / steps


def max_abs_err(got: torch.Tensor, want: torch.Tensor) -> int:
    """The largest |got - want| over the elements, as integers; raises if
    the shapes or dtypes differ."""
    if got.shape != want.shape or got.dtype != want.dtype:
        raise AssertionError(f"shape/dtype differ: {got.shape} {got.dtype} vs "
                             f"{want.shape} {want.dtype}")
    if got.numel() == 0:
        return 0
    return int((got.to(torch.int64) - want.to(torch.int64)).abs().max())


def check_equal(name: str, got: torch.Tensor, want: torch.Tensor) -> int:
    """got's max_abs_err against want; raises unless it is 0 (tolerance
    zero: the probes compute integer functions)."""
    err = max_abs_err(got, want)
    if err:
        raise AssertionError(f"{name}: kernel differs from its plain version (max |err| {err})")
    return err


def check_calls(name: str, calls: dict, want) -> int:
    """Launch every timed call once and hold its output against want(label),
    the plain version at the same shape; returns the max_abs_err (0)."""
    return max(check_equal(f"{name} {label}", fn(), want(label)) for label, fn in calls.items())


def tile(x: torch.Tensor, n: int) -> torch.Tensor:
    """x's elements repeated to n elements, 1-D: a script's inputs at a
    shape that fills the card."""
    flat = x.reshape(-1)
    return flat.repeat(-(-n // flat.numel()))[:n].contiguous()
