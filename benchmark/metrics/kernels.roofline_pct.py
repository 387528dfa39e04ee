"""Layer: kernels (csrc/mont_mul.cu, group.cu, msm_scan.cu).  Sum over
the traced window's launches of each launch's bound (the larger of its
32-bit multiply-adds over the card's peak and its bytes over the card's
bandwidth; benchmark/kernels/*.json, benchmark/peaks.json) over the sum
of those kernels' device time (torch.profiler), in percent.  Nothing is
reported without launches, device time or the card's peaks."""

from harness import roofline, spec, trace

LAYER, UNIT, MOVES, SOURCE = "Kernels", "%", "proof_s", "device_trace"


def read(run):
    t = run.get("trace")
    if not t or not t.get("peaks") or not t["launches"]:
        return None
    mad_rate, bw, _ = t["peaks"]
    kernels = spec.kernels()
    bounds = roofline.bound_seconds(kernels, t["launches"], mad_rate, bw)
    bound = sum(b for b, n in bounds.values())
    names = {k["device_name"] for k in kernels.values()}
    device = sum(trace.device_seconds(t["kernel_s"], n) for n in names)
    if not bound or not device:
        return None
    return 100.0 * bound / device
