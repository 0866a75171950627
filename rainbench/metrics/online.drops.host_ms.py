"""online.drops.host_ms (ms): the host's median ms a render step inside
the harness's online.drops span (rainbench/harness.OnlineDrops: the
online job's simulation of the batch's frames, its truncation count,
the compaction to the render capacity and the texture picks), over the
window's untraced steps (rainbench/spans.py). The compaction reads the
batch's largest valid count, which waits for the simulation on the
device: this is the host's issue of the drop source and that wait."""

from rainbench import spans


def read(run):
    return spans.host_ms(run, "online.drops")
