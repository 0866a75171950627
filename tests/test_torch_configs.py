"""The port's config dataclasses are field-for-field copies of the JAX
package's (PipelineConfig less its TPU layout knobs; its composite_mode
is the port's too)."""

import dataclasses

import pytest

from raintpu.ops import rasterize as jrz
from raintpu.physics import simulator as jsim
from raintpu.render import frame as jframe
from raintpu.render.camera import CameraSettings, RenderSettings
from raintpu_torch.ops import rasterize as trz
from raintpu_torch.physics import simulator as tsim
from raintpu_torch.render import frame as tframe

# TPU layout knobs of the JAX PipelineConfig that the port leaves out.
TPU_ONLY = {"row_strip", "pair_eval", "narrow_dma", "resident"}

_LADDER = dict(ph=24, pw=32, radius=5, capacity=224, modes_y=12,
               modes_x=6, ranks=3)


def _settings():
    return RenderSettings(camera=CameraSettings(wh=(96, 48),
                                                ccd_wh=(96, 48)))


def _pair(name):
    if name == "BucketSpec":
        return jrz.BucketSpec(**_LADDER), trz.BucketSpec(**_LADDER)
    if name == "RasterConfig":
        kw = dict(supersample=3, coc_pixsize=5e-6, modal_blur=False)
        return (jrz.RasterConfig(buckets=(jrz.BucketSpec(**_LADDER),), **kw),
                trz.RasterConfig(buckets=(trz.BucketSpec(**_LADDER),), **kw))
    if name == "RasterConfig.default":
        return jrz.RasterConfig.default(320), trz.RasterConfig.default(320)
    if name == "PipelineConfig":
        kw = dict(settings=_settings(), image_hw=(48, 96), fallrate=25.0,
                  env_downsample=8, cone_downsample=4, env_fold=False,
                  composite_mode="xla")
        return (jframe.PipelineConfig(
                    raster=jrz.RasterConfig.default(64), **kw),
                tframe.PipelineConfig(
                    raster=trz.RasterConfig.default(64), **kw))
    if name == "PipelineConfig.build":
        args = (_settings(), (48, 96), 10)
        return (jframe.PipelineConfig.build(*args, drop_capacity=128),
                tframe.PipelineConfig.build(*args, drop_capacity=128))
    if name == "SimConfig":
        kw = dict(image_wh=(96, 48), focal_px=(300.0, 310.0),
                  exposure_s=2e-3, capacity=32, z_max=5.0, z_bins=64)
        return jsim.SimConfig(**kw), tsim.SimConfig(**kw)
    if name == "SimConfig.from_settings":
        st = RenderSettings(camera=CameraSettings())
        return (jsim.SimConfig.from_settings(st, capacity=512),
                tsim.SimConfig.from_settings(st, capacity=512))
    raise KeyError(name)


@pytest.mark.parametrize("name", [
    "BucketSpec", "RasterConfig", "RasterConfig.default", "PipelineConfig",
    "PipelineConfig.build", "SimConfig", "SimConfig.from_settings"])
def test_configs_match_field_for_field(name):
    j, t = _pair(name)
    jd, td = dataclasses.asdict(j), dataclasses.asdict(t)
    if name.startswith("PipelineConfig"):
        assert set(jd) - set(td) == TPU_ONLY
        jd = {k: v for k, v in jd.items() if k not in TPU_ONLY}
    assert jd == td


def test_pipeline_config_derived_values_match():
    j, t = _pair("PipelineConfig")
    assert j.image_wh == t.image_wh
    for cds, fold in ((1, True), (4, True), (4, False), (6, True)):
        jc = dataclasses.replace(j, cone_downsample=cds, env_fold=fold)
        tc = dataclasses.replace(t, cone_downsample=cds, env_fold=fold)
        assert jframe.env_downsamples(jc) == tframe.env_downsamples(tc)
