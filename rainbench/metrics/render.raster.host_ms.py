"""render.raster.host_ms (ms): the host's median ms a render step
inside the program's render.raster span (render/frame.kernel_rungs and
ops/fused_raster.fused_raster_composite: the kernel's operands, its
tile plan and its launch), over the window's untraced steps
(rainbench/spans.py). The span does not synchronize: this is the time
the host took to issue the stage, a wait for room in the launch queue
included."""

from rainbench import spans


def read(run):
    return spans.host_ms(run, "render.raster")
