"""The kernels' bound: work counts from benchmark/kernels/*.json, peaks
from benchmark/peaks.json and the card.

A kernel file names the ctypes entry point that launches the kernel, the
names of its arguments, the device name of the kernel in the trace, and
expressions, over those arguments and the field degree `deg`, for the
lanes of a launch, the Fq products a lane needs by its algorithm and the
bytes a launch reads once and writes once.  A launch's bound is the
larger of its 32-bit multiply-adds over the card's peak rate and its
bytes over the card's bandwidth.
"""

import subprocess

import torch


def _eval(expr, env: dict) -> float:
    if isinstance(expr, (int, float)):
        return expr
    return eval(expr, {"__builtins__": {}}, dict(env))


def card_peaks(peaks: dict, device_index: int = 0):
    """(int32 multiply-adds per second, bytes per second, facts) of the
    card at run time: SM count from torch, the maximum SM and memory
    clocks and the power limit from nvidia-smi.  None where they cannot
    be read."""
    try:
        out = subprocess.run(
            ["nvidia-smi", "-i", str(device_index),
             "--query-gpu=clocks.max.sm,clocks.max.mem,power.limit",
             "--format=csv,noheader,nounits"], capture_output=True,
            text=True, timeout=30, check=True).stdout.strip().splitlines()[0]
        sm_mhz, mem_mhz, power_w = (float(x) for x in out.split(","))
    except (OSError, subprocess.SubprocessError, ValueError, IndexError):
        return None
    sms = torch.cuda.get_device_properties(device_index).multi_processor_count
    mads = sms * peaks["int32_mad_per_sm_per_clock"] * sm_mhz * 1e6
    bw = mem_mhz * 1e6 * peaks["hbm_transfers_per_clock"] \
        * peaks["hbm_bus_bits"] / 8
    return mads, bw, {"sm_count": sms, "sm_clock_max_mhz": sm_mhz,
                      "mem_clock_max_mhz": mem_mhz, "power_limit_w": power_w,
                      "int32_mad_per_s": mads, "hbm_bytes_per_s": bw}


def match(kernel: dict, symbol: str, args: tuple):
    """The environment (argument values by name, deg) of a launch of
    `kernel`, or None if the launch is another kernel's."""
    launcher = kernel["launcher"]
    if launcher.endswith("_"):
        if not symbol.startswith(launcher):
            return None
        cfg = symbol[len(launcher):]
        deg = kernel["degree_by_cfg"].get(cfg)
        if deg is None:
            return None
    elif symbol == launcher:
        deg = 1
    else:
        return None
    env = dict(zip(kernel["args"], args))
    env["deg"] = deg
    for k, v in kernel.get("select", {}).items():
        if env.get(k) != v:
            return None
    return env


def launch_work(kernel: dict, env: dict):
    """(multiply-adds, bytes) of one launch."""
    lanes = _eval(kernel["lanes"], env)
    products = kernel["fq_products_per_lane"][str(env["deg"])]
    mads = lanes * products * kernel["mads_per_fq_product"]
    return mads, _eval(kernel["bytes"], env)


def bound_seconds(kernels: dict, launches, mad_rate: float, bw: float):
    """Per kernel name: (bound seconds summed over its launches, launch
    count)."""
    out = {name: [0.0, 0] for name in kernels}
    for symbol, args in launches:
        for name, k in kernels.items():
            env = match(k, symbol, args)
            if env is None:
                continue
            mads, nbytes = launch_work(k, env)
            out[name][0] += max(mads / mad_rate, nbytes / bw)
            out[name][1] += 1
    return out
