"""The multi-device dry run (port of ``__graft_entry__.py:65-140``): one full
sharded engine step of two tumbling boxes on an (n/2, 2) mesh (objects ×
space; (n, 1) for odd n or n < 4), then the halo exchange's min filter on
the same mesh, in ``n`` spawned ranks.

    python -m impact_tpu_torch.parallel.dryrun --ranks 8 --device cpu
    python -m impact_tpu_torch.parallel.dryrun --ranks 4 --backend gloo   # one card

On the card each rank needs a card of its own unless ``--backend gloo``
stages the collectives through host memory (ranks sharing a card say
nothing about a multi-card speed).
"""

from __future__ import annotations

import argparse
import sys
import time

from .jobs import dryrun_job
from .world import World


def dryrun_multichip(n_devices: int, device="cuda", backend: str | None = None,
                     store_dir=None) -> dict:
    """Spawn ``n_devices`` ranks, run the dry run in them, print its line and
    return rank 0's report. Raises if a rank fails, the stepped bodies are
    not finite or the filter differs from the plain 3-point min."""
    t0 = time.perf_counter()
    with World(n_devices, device=device, backend=backend, store_dir=store_dir) as world:
        reports = world.run(dryrun_job, n_devices)
        backend = world.backend
    r = reports[0]
    if not all(x["finite"] and x["halo_equal"] for x in reports):
        raise AssertionError(f"dry run: {reports}")
    print(f"dryrun_multichip OK: {n_devices} ranks ({backend} on {device}), mesh "
          f"{dict(objects=r['mesh'][0], space=r['mesh'][1])} for one full engine step "
          f"({r['step_s']:.1f} s, {r['step_halos']} halo transfers), "
          f"{dict(objects=r['halo_mesh'][0], space=r['halo_mesh'][1])} "
          f"for the halo exchange ({r['halo_s']:.2f} s), total "
          f"{time.perf_counter() - t0:.1f} s", flush=True)
    return r


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--ranks", type=int, default=8)
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--backend", default=None, choices=(None, "gloo", "nccl"))
    args = ap.parse_args(argv)
    dryrun_multichip(args.ranks, device=args.device, backend=args.backend)
    return 0


if __name__ == "__main__":
    sys.exit(main())
