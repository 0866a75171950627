"""render.envmap.host_ms (ms): the host's median ms a render step
inside the program's render.envmap span (render/frame.frame_background's
ops/envmap calls: the envmap at photometry resolution, and at full
resolution when it is saved), over the window's untraced steps
(rainbench/spans.py). The span does not synchronize: this is the time
the host took to issue the stage, a wait for room in the launch queue
included."""

from rainbench import spans


def read(run):
    return spans.host_ms(run, "render.envmap")
