"""separable_blur_roofline (%): the fog blur kernel's (K4) share of its
roofline (counts/separable_blur.py) over the traced steps."""

from rainbench import roofline


def read(run):
    return roofline.share(run, "separable_blur")
