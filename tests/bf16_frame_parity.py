"""Scores of ``tpu.bf16_shading`` frames in both packages on the CPU: the
reference tester's ShadowableOmnidirectionalLight through both parity
harnesses (the reference's configuration captured on ``EngineConfig()``),
rendered with bfloat16 shading off and on, and each pair scored with
``rgb_hybrid_compare``. It shows what a bfloat16 frame scores against the
float32 one in the reference itself, beside the port's. Not a test (pytest
does not collect it); run from the repository root:

    python tests/bf16_frame_parity.py [--size 768x512] [--shadow 1024] [--scene NAME]

At 768x512 with 1024² maps it takes a few minutes and a few GiB here.
"""

import argparse
import os
import pathlib
import sys

import jax

jax.config.update("jax_platforms", "cpu")

ROOT = pathlib.Path(__file__).resolve().parents[1]
sys.path[:0] = [str(ROOT), str(ROOT / "tests")]
os.chdir(ROOT)


def main(argv=None):
    import numpy as np
    import pytest
    from test_torch_parity_scenes import jcompile, reference_config

    from impact_tpu.models.parity_scenes import PARITY_SCENES as JPARITY
    from impact_tpu.runtime import HeadlessRuntime as JRuntime
    from impact_tpu_torch.apps import parity_snapshots as ps
    from impact_tpu_torch.utils.config import EngineConfig
    from impact_tpu_torch.utils.image import rgb_hybrid_compare

    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--size", default="768x512")
    ap.add_argument("--shadow", type=int, default=1024)
    ap.add_argument("--scene", default="ShadowableOmnidirectionalLight")
    args = ap.parse_args(argv)
    w, h = (int(x) for x in args.size.split("x"))

    def cut(cfg, bf16):
        cfg.tpu.render_width, cfg.tpu.render_height = w, h
        cfg.rendering.shadow_mapping.omnidirectional_light_shadow_map_resolution = args.shadow
        cfg.tpu.bf16_shading = bf16
        return cfg

    def reference(bf16):
        cfg = cut(reference_config(args.scene), bf16)
        rt = JRuntime(jcompile(JPARITY[args.scene][0](), cfg), cfg, enable_fracturing=False,
                      enable_absorption=False, enable_splitting=False)
        return np.asarray(rt.render())

    def port(bf16):
        with pytest.MonkeyPatch.context() as mp:
            mp.setattr(ps, "WIDTH", w)
            mp.setattr(ps, "HEIGHT", h)
            rt = ps.build_runtime(args.scene, cut(EngineConfig(), bf16), device="cpu")
            return rt.render().numpy()

    j32, j16, t32, t16 = reference(False), reference(True), port(False), port(True)
    print(f"{args.scene} at {w}x{h}, {args.shadow}² maps:")
    for name, a, b in (("reference bf16 vs reference float32", j16, j32),
                       ("port bf16 vs port float32", t16, t32),
                       ("port bf16 vs reference bf16", t16, j16),
                       ("port float32 vs reference float32", t32, j32)):
        print(f"  {name}: {rgb_hybrid_compare(a, b):.5f} "
              f"({int((a != b).any(axis=-1).sum())} pixels differ)")
    return 0


if __name__ == "__main__":
    sys.exit(main())
