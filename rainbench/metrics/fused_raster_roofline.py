"""fused_raster_roofline (%): the raster+composite kernel's share of
its roofline (counts/fused_raster.py) over the traced steps."""

from rainbench import roofline


def read(run):
    return roofline.share(run, "fused_raster")
