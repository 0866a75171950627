"""Camera and render settings.

The port's copy of ``raintpu.render.camera``, field for field: the
settings dictionary of the reference (``common/db.py:8-70``) as frozen,
hashable dataclasses. All defaults match the reference defaults exactly.
"""

from __future__ import annotations

import dataclasses
from typing import Mapping, Optional, Tuple


@dataclasses.dataclass(frozen=True)
class CameraSettings:
    """Camera intrinsics/extrinsics (reference ``common/db.py:9-23``).

    Units follow the reference: focal in mm, exposure in ms, CCD pixel size
    in micrometers, positions in meters.
    """

    hz: float = 10.0                       # cam_hz — frame rate
    ccd_wh: Tuple[int, int] = (1242, 375)  # cam_CCD_WH (pixels)
    ccd_pixsize: float = 4.65              # cam_CCD_pixsize (µm)
    wh: Tuple[int, int] = (1242, 375)      # cam_WH — image resolution
    focal: float = 6.0                     # cam_focal (mm)
    gain: float = 20.0                     # cam_gain
    f_number: float = 6.0                  # cam_f_number
    focus_plane: float = 6.0               # cam_focus_plane (m)
    exposure: float = 2.0                  # cam_exposure (ms)
    pos: Tuple[float, float, float] = (1.5, 1.5, 0.3)
    lookat: Tuple[float, float, float] = (1.5, 1.5, -1.0)
    up: Tuple[float, float, float] = (0.0, 1.0, 0.0)

    @property
    def exposure_s(self) -> float:
        """Exposure time in seconds."""
        return self.exposure * 1e-3

    @property
    def focal_m(self) -> float:
        """Focal length in meters (the reference's ``Generator.focal``)."""
        return self.focal / 1000.0

    @property
    def focal_px(self) -> float:
        """Focal length in pixels from CCD specs (mm / µm)."""
        return self.focal * 1e-3 / (self.ccd_pixsize * 1e-6)

    def validate(self) -> None:
        """Reference ``common/db.py:103-107`` (assert_settings)."""
        import numpy as np

        if self.exposure > 1000.0 / self.hz:
            raise ValueError(
                "Exposure should be lower than 1000/Hz otherwise camera "
                "frames temporally overlap.")
        if self.lookat[2] >= 0:
            raise ValueError("Z axis of cam_lookat should be negative.")
        if not np.isclose(np.linalg.norm(np.asarray(self.up)), 1.0):
            raise ValueError("cam_up must be of norm 1.")


@dataclasses.dataclass(frozen=True)
class SimSettings:
    """Particle-simulation parameters (reference ``common/db.py:43-67``).

    ``steps`` carries per-camera-frame schedules; only the keys the
    reference wrapper supports are honored: ``cam_motion`` (km/h),
    ``cam_exposure`` (ms), ``cam_focal`` (mm), ``rain_fallrate`` (mm/hr).
    Stored as tuples to stay hashable.
    """

    hz: float = 2000.0          # sim_hz — simulator tick rate
    mode: str = "normal"        # sim_mode: normal | steps
    duration: float = 34.0      # sim_duration (s); overridden in steps mode
    steps: Tuple[Tuple[str, Tuple[float, ...]], ...] = ()

    def steps_dict(self) -> Mapping[str, Tuple[float, ...]]:
        return dict(self.steps)

    @staticmethod
    def from_dict(d: Mapping) -> "SimSettings":
        steps = tuple(
            (str(k), tuple(float(x) for x in v))
            for k, v in dict(d.get("sim_steps", {})).items())
        return SimSettings(
            hz=float(d.get("sim_hz", 2000.0)),
            mode=str(d.get("sim_mode", "normal")),
            duration=float(d.get("sim_duration", 34.0)),
            steps=steps,
        )


@dataclasses.dataclass(frozen=True)
class RenderSettings:
    """Full render configuration = camera + scales + aesthetics.

    ``depth_scale``/``render_scale`` semantics follow the reference
    (``common/db.py:26-41``):
      image_size = original_image_size // render_scale
      depth_size = (original_depth_size * depth_scale) // render_scale
    """

    camera: CameraSettings = CameraSettings()
    sim: SimSettings = SimSettings()
    depth_scale: int = 1
    render_scale: int = 1

    # Aesthetic knobs (reference ``main.py:46-55``)
    noise_scale: float = 0.0
    noise_std: float = 0.0
    opacity_attenuation: float = 1.0

    # Rendering strategy: None (physics) | "white" | "naive_db"
    # (reference ``main.py:104-109`` consumed at ``bad_weather.py:349-360``)
    rendering_strategy: Optional[str] = None

    # Irradiance / envmap modes (reference ``generator.py:70-71``)
    env_type: str = "ours"       # 'ours' | 'pano'
    irrad_type: str = "ambient"  # 'garg' | 'ambient'

    # Renderer constants (reference ``generator.py:267``)
    focus_plane: float = 6.0     # RainRenderer focus_plane
    sphere_radius: float = 10.0  # RainRenderer radius
    drop_fov_deg: float = 165.0  # RainRenderer fov

    def validate(self) -> None:
        if not (self.render_scale >= 1 and isinstance(self.render_scale, int)):
            raise ValueError("render_scale must be an int >= 1")
        self.camera.validate()


def settings_from_dict(d: Mapping) -> RenderSettings:
    """Build a RenderSettings from a reference-style settings dict.

    Accepts the exact key names of ``common/db.py`` so dataset plugin
    modules written against the reference keep working.
    """
    cam = CameraSettings(
        hz=float(d.get("cam_hz", 10)),
        ccd_wh=tuple(int(v) for v in d.get("cam_CCD_WH", (1242, 375))),
        ccd_pixsize=float(d.get("cam_CCD_pixsize", 4.65)),
        wh=tuple(int(v) for v in d.get("cam_WH", (1242, 375))),
        focal=float(d.get("cam_focal", 6)),
        gain=float(d.get("cam_gain", 20)),
        f_number=float(d.get("cam_f_number", 6.0)),
        focus_plane=float(d.get("cam_focus_plane", 6.0)),
        exposure=float(d.get("cam_exposure", 2)),
        pos=tuple(float(v) for v in d.get("cam_pos", (1.5, 1.5, 0.3))),
        lookat=tuple(float(v) for v in d.get("cam_lookat", (1.5, 1.5, -1.0))),
        up=tuple(float(v) for v in d.get("cam_up", (0.0, 1.0, 0.0))),
    )
    return RenderSettings(
        camera=cam,
        sim=SimSettings.from_dict(d),
        depth_scale=int(d.get("depth_scale", 1)),
        render_scale=int(d.get("render_scale", 1)),
    )
