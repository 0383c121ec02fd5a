"""Scene specification: frozen, hashable dataclasses.

Counterpart of `plasticinelab_tpu/config/spec.py`, field for field, minus
the two TPU-only switches there (`remat`, `transfer`): this port keeps no
rematerialisation policy and has one transfer path. The derived simulator
quantities (grid size, dt, substeps, Lame parameters) are computed exactly
as the reference does (plb/engine/mpm_simulator.py:15-34).
"""
from __future__ import annotations

import dataclasses
from dataclasses import dataclass, field
from typing import Optional, Tuple

Vec3 = Tuple[float, float, float]
Vec4 = Tuple[float, float, float, float]


@dataclass(frozen=True)
class SimulatorSpec:
    dim: int = 3
    quality: float = 1.0
    yield_stress: float = 50.0
    dtype: str = "float32"  # reference asserts float64; the kernels are f32
    max_steps: int = 1024   # API parity only — no trajectory buffer exists here
    n_particles: int = 9000
    E: float = 5e3
    nu: float = 0.2
    ground_friction: float = 1.5
    gravity: Vec3 = (0.0, -1.0, 0.0)
    # CFL-bounded grid-velocity clamp, as a fraction of dx/dt (0 disables).
    # In float32, stiff pinch contacts drive a v -> C -> F feedback past the
    # float32 range; clamping |v| at 0.5*dx/dt is inactive in every sane
    # regime and bounds that feedback.
    grid_v_clamp: float = 0.5

    # ---- derived (reference mpm_simulator.py:15-34) ----
    @property
    def eff_quality(self) -> float:
        return self.quality * 0.5 if self.dim == 3 else self.quality

    @property
    def n_grid(self) -> int:
        return int(128 * self.eff_quality)

    @property
    def dx(self) -> float:
        return 1.0 / self.n_grid

    @property
    def inv_dx(self) -> float:
        return float(self.n_grid)

    @property
    def dt(self) -> float:
        return 0.5e-4 / self.eff_quality

    @property
    def substeps(self) -> int:
        return int(2e-3 // self.dt)

    @property
    def p_vol(self) -> float:
        return (self.dx * 0.5) ** 2

    @property
    def p_rho(self) -> float:
        return 1.0

    @property
    def p_mass(self) -> float:
        return self.p_vol * self.p_rho

    @property
    def mu_0(self) -> float:
        return self.E / (2 * (1 + self.nu))

    @property
    def lam_0(self) -> float:
        return self.E * self.nu / ((1 + self.nu) * (1 - 2 * self.nu))


@dataclass(frozen=True)
class PrimitiveSpec:
    """One rigid SDF manipulator (reference primive_base.py:209-224 defaults,
    shape-specific params from primitives.py per-class default_config)."""

    shape: str = ""                      # Sphere|Capsule|RollingPin|Chopsticks|Cylinder|Torus|Box
    init_pos: Vec3 = (0.3, 0.3, 0.3)
    init_rot: Vec4 = (1.0, 0.0, 0.0, 0.0)
    color: Vec3 = (0.3, 0.3, 0.3)
    lower_bound: Vec3 = (0.0, 0.0, 0.0)
    upper_bound: Vec3 = (1.0, 1.0, 1.0)
    friction: float = 0.9
    action_dim: int = 0
    action_scale: Tuple[float, ...] = ()
    # shape parameters (only those relevant to `shape` are used)
    radius: float = 1.0                  # Sphere
    h: float = 0.06                      # Capsule/RollingPin/Chopsticks/Cylinder
    r: float = 0.03
    size: Vec3 = (0.1, 0.1, 0.1)         # Box
    tx: float = 0.2                      # Torus
    ty: float = 0.1
    minimal_gap: float = 0.06            # Chopsticks
    init_gap: float = 0.06

    @property
    def state_dim(self) -> int:
        return 8 if self.shape == "Chopsticks" else 7

    @property
    def init_state(self) -> Tuple[float, ...]:
        s = tuple(self.init_pos) + tuple(self.init_rot)
        if self.shape == "Chopsticks":
            s = s + (self.init_gap,)
        return s


@dataclass(frozen=True)
class ShapeSpec:
    """Initial particle cloud source (reference shape_maker.py)."""

    shape: str = "box"                   # box|sphere
    init_pos: Vec3 = (0.5, 0.5, 0.5)
    width: Optional[Vec3] = None         # box
    radius: Optional[float] = None       # sphere
    n_particles: Optional[int] = 10000
    color: Optional[int] = None
    init_rot: Optional[Vec4] = None


@dataclass(frozen=True)
class RendererSpec:
    """Reference default_config.py:39-57."""

    spp: int = 50
    max_ray_depth: int = 2
    image_res: Tuple[int, int] = (512, 512)
    voxel_res: Vec3 = (168, 168, 168)
    target_res: Vec3 = (64, 64, 64)
    dx: float = 1.0 / 150
    sdf_threshold: float = 0.37 * 0.56
    bake_size: int = 6
    use_roulette: bool = False
    light_direction: Vec3 = (2.0, 1.0, 0.7)
    camera_pos: Vec3 = (0.5, 1.2, 4.0)
    camera_rot: Tuple[float, float] = (0.2, 0.0)
    use_directional_light: bool = False
    max_num_particles: int = 1000000


@dataclass(frozen=True)
class LossSpec:
    """Reference default_config.py:64-70."""

    soft_contact: bool = False
    weight_sdf: float = 10.0
    weight_density: float = 10.0
    weight_contact: float = 1.0
    target_path: str = ""


@dataclass(frozen=True)
class EnvSpec:
    loss: LossSpec = field(default_factory=LossSpec)
    n_observed_particles: int = 200


@dataclass(frozen=True)
class SceneSpec:
    simulator: SimulatorSpec = field(default_factory=SimulatorSpec)
    primitives: Tuple[PrimitiveSpec, ...] = ()
    shapes: Tuple[ShapeSpec, ...] = ()
    renderer: RendererSpec = field(default_factory=RendererSpec)
    env: EnvSpec = field(default_factory=EnvSpec)

    @property
    def action_dim(self) -> int:
        return sum(p.action_dim for p in self.primitives)

    @property
    def action_dims(self) -> Tuple[int, ...]:
        """Cumulative action offsets per primitive (reference primitives.py:274-278)."""
        out = [0]
        for p in self.primitives:
            out.append(out[-1] + p.action_dim)
        return tuple(out)

    @property
    def primitive_state_dim(self) -> int:
        return sum(p.state_dim for p in self.primitives)

    def replace(self, **kw) -> "SceneSpec":
        return dataclasses.replace(self, **kw)

    def with_n_particles(self, n: int) -> "SceneSpec":
        return self.replace(simulator=dataclasses.replace(self.simulator, n_particles=n))
