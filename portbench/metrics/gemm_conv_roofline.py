"""``gemm_conv_roofline``: over the recorded matmuls, convolutions and
convolution backwards outside attention (``portbench/trace/work.py``), the
sum of their bounds over the sum of their device ms, in %."""

from portbench.trace.work import parse_ops


def read(view):
    attention = {id(e) for e in view.attention()[0]}
    index = parse_ops(view.trace, linked=[(e, op) for e, op in view.linked if id(e) not in attention])
    bound = device = 0.0
    for op_id in index.work:
        ms = index.device_ms(op_id)
        if ms > 0:
            bound += index.bound_ms(op_id)
            device += ms
    return 100.0 * bound / device if device > 0 else None
