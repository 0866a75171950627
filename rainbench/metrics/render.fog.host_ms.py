"""render.fog.host_ms (ms): the host's median ms a render step inside
the program's render.fog span (render/frame.batched_fog: ops/fog's fog
layer and its K4 blur launch), over the window's untraced steps
(rainbench/spans.py). The span does not synchronize: this is the time
the host took to issue the stage, a wait for room in the launch queue
included."""

from rainbench import spans


def read(run):
    return spans.host_ms(run, "render.fog")
