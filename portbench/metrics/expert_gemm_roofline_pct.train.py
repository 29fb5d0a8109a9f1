"""expert_gemm_roofline_pct.train: the least time of the traced steps' K13
calls (each layer's six grouped GEMMs at the rows the program counted it
route to the held experts, ``moe.rows``; ``portbench.flops_moe``) over
K13's device time."""

import re

from portbench import counters, flops_moe, trace

K13 = re.compile(r"\bgrouped_gemm_(rows|dw)\b")


def read(ctx):
    ev, span = ctx["events"], ctx["span"]
    rows = counters.program_counts("moe.rows")
    if span is None or rows is None:
        return None
    us = trace.kernel_us(ev, span, K13)
    if us <= 0:
        return None
    shape = ctx["cell"]["config"]["port"]
    least = sum(flops_moe.expert_gemm_least_seconds(shape, r[0])
                for r in rows)
    return 100.0 * least / (us / 1e6)
