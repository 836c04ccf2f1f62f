"""Render configuration.

One declarative options object replaces the reference's two-tier config:
compile-time #defines (global.hpp:14-33, MAX_DEPTH PathTracing.hpp:5-6,
MAXDEPTH LightTracing.hpp:6, MAX_PATHLENGTH BDPT.hpp:8) plus the runtime
keyword file (PPMGenerator.hpp:488-791). All fields are static Python
values: they select compiled program variants.
"""
from __future__ import annotations

import dataclasses

EPSILON = 5e-4          # global.hpp:16
MIN_DIVISOR = 0.04      # global.hpp:26
GAMMA_VAL = 0.78        # global.hpp:30


@dataclasses.dataclass(frozen=True)
class RenderOptions:
    spp: int = 64                 # global.hpp:19
    max_depth: int = 6            # PathTracing.hpp:5
    min_depth: int = 3            # PathTracing.hpp:6 (RR warmup)
    lt_max_depth: int = 2         # LightTracing.hpp:6 (shared MAXDEPTH)
    bdpt_max_path_length: int = 7  # BDPT.hpp:8
    mis: bool = True              # global.hpp:25
    russian_roulette: bool = True
    jitter: bool = False          # reference has no sub-pixel jitter
    gamma: float = GAMMA_VAL
    # alpha-weighted soft shadows: NEE visibility becomes the product of
    # (1-alpha) over occluders (strategy-layer getShadowCoeffi,
    # BVHStrategy.hpp:13-45 — present in the reference but never wired to
    # an integrator; here it is a first-class switch)
    alpha_shadows: bool = False
    # BDPT debug harness (the reference's compile-time CHECK/S_CHECK/
    # T_CHECK/CHECK_MIS flags, BDPT.hpp:9-12, 490-493, 760-762): isolate a
    # single strategy family by its s (light-subpath length) and/or t
    # (eye-subpath length), and optionally drop the MIS weight so each
    # strategy's unweighted contribution can be validated in isolation.
    # -1 disables a filter. Static fields -> compiled specializations,
    # exactly like the reference's #define variants.
    bdpt_s_filter: int = -1
    bdpt_t_filter: int = -1
    bdpt_unweighted: bool = False
    # compat knobs reproducing reference quirks (see SURVEY.md quirks list)
    tutu_light_pick: bool = False
    tutu_tri_sample: bool = False
    ggx_sample_bug: bool = False
    # the reference zeroes any BDPT strategy whose MIS weight is below
    # MIN_DIVISOR (BDPT.hpp:218-219), losing a few % of energy vs PT; with
    # the knob off the weights form an exact partition of unity and BDPT
    # agrees with PT to MC noise (tested in test_integrators.py)
    tutu_bdpt_weight_kill: bool = True
    # the reference breaks out of the per-pixel SPP loop when the primary
    # ray misses (BDPT.hpp:733-734), so miss-pixels trace NO light paths;
    # since every pixel's light path can splat anywhere (t=1), this scales
    # the t=1 contribution by the scene's primary-hit fraction — invisible
    # in the reference's closed rooms (hit fraction 1.0), a real energy
    # loss in open scenes. On (default) = reference behavior; off = light
    # paths splat regardless of the lane's own eye hit (unbiased).
    tutu_bdpt_t1_gate: bool = True
    # batching: rays processed per device dispatch (0 = whole frame)
    rays_per_pass: int = 0
    # samples batched into ONE wavefront launch (path tracer): wider
    # launches amortise per-launch overhead. Purely a scheduling choice —
    # the image is bit-identical.
    # 1 = one launch per sample (default; right for small scenes).
    samples_per_launch: int = 1
    # wavefront compaction: per-bounce live-lane fraction schedule (static).
    # Empty = off. Each entry is the buffer size for that bounce as a
    # fraction of the wavefront; live lanes are gathered to the front.
    # Size with margin above the scene's measured alive fractions: if the
    # live count ever exceeds the buffer, a uniformly random subset
    # survives and is upweighted by cnt/k (unbiased stochastic lane
    # roulette; a runtime warning is printed) — undersized buffers cost
    # variance, never energy.
    # Measured: a wash on Cornell (alive stays >30% to depth 5), a 2.6x
    # win on the 100k-tri open scene (alive collapses to 21%/7%/3% after
    # bounce 1; 32.7s -> 12.7s at 512^2 x 16spp) — use on large/open
    # scenes, derive the schedule from trace_rays(collect_alive=True)
    # (see bench.py:bench_sphere_100k)
    compaction: tuple = ()
    # detach sampling decisions (directions, pdfs, RR, MIS weights) so the
    # estimator is differentiable w.r.t. material parameters with correct
    # detached-sampling gradients
    differentiable: bool = False
