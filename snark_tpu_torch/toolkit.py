"""Shared plumbing of the port's profilers and benches (`profile_*.py`,
`bench_affine_msm`, `bench_scan_overlap`, `bench_gather`, `bench_synth`,
`gen_vectors`): the device argument, the timers and the JSON lines.

Each tool takes `--device` (default "cuda"). On a card it times with CUDA
events around real launches and puts the card's name and power limit, as
`nvidia-smi --query-gpu=name,power.limit --format=csv,noheader` gives
them, on every line. On the CPU, which only a caller that asks for it
gets (the tests run the tools there at tiny sizes on the kernels' plain
versions), it times by the host clock and `nvidia_smi` is null. A card that
was asked for and is missing raises; nothing falls back to the CPU.
"""

from __future__ import annotations

import argparse
import json
import time

import torch

from .bench import nvidia_smi


def parser(description: str) -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(description=description.strip().splitlines()[0])
    ap.add_argument("--device", default="cuda", help="cuda (the default) or cpu")
    return ap


def resolve(device) -> torch.device:
    """The torch device asked for; raises when it is a card and there is
    none."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("no CUDA device (pass --device cpu to run the plain versions)")
    return dev


def card(device: torch.device) -> dict:
    """{"device": the card's name or "cpu", "nvidia_smi": name and power
    limit, or None on the CPU}."""
    if device.type != "cuda":
        return {"device": "cpu", "nvidia_smi": None}
    return {"device": torch.cuda.get_device_name(device), "nvidia_smi": nvidia_smi()}


def sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def time_ms(fn, device: torch.device, iters: int = 3) -> float:
    """Mean milliseconds of fn() over `iters` calls after one warm-up call:
    between two CUDA events on a card, by the host clock (each call ending
    in a synchronise) on the CPU."""
    return timed(fn, device, iters)[0]


def timed(fn, device: torch.device, iters: int = 3):
    """(`time_ms`, the output of the warm-up call)."""
    out = fn()
    sync(device)
    if device.type != "cuda":
        return host_ms(fn, device, iters), out
    a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    a.record()
    for _ in range(iters):
        fn()
    b.record()
    torch.cuda.synchronize(device)
    return a.elapsed_time(b) / iters, out


def host_ms(fn, device: torch.device, iters: int = 3) -> float:
    """Mean milliseconds of fn() over `iters` calls by the host clock, each
    call ending in a synchronise."""
    sync(device)
    t0 = time.perf_counter()
    for _ in range(iters):
        fn()
        sync(device)
    return (time.perf_counter() - t0) / iters * 1e3


def emit(rec: dict) -> dict:
    print(json.dumps(rec), flush=True)
    return rec
