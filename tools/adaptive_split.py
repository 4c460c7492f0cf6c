"""Phase 19 of ``chip_smoke.py`` (service recovery) with the adaptive
batching controls off and on, in turns, then phase 20 once: what the
adaptive wait and width controllers (``reporter_tpu_torch/obs/adaptive.py``,
on by default) do to phase 19's kernel launches and batches.

    python3 tools/adaptive_split.py [--rows 120] [--device cuda] [--rounds 1]

Builds the kernels, the realistic city of ``chip_smoke.py``'s phase 17 at
ROWS x ROWS with its cohorts, phase 17's serve and phase 18's wire (which
give phase 19 its two matchers), then runs phase 19's steps with
REPORTER_ADAPTIVE=0, =1, =1, =0 (``--rounds`` such quartets; the
batchers read it when they are built, and every step builds its own):
per step (19.1 faults off, 19.2 poison, 19.3 watchdog, 19.4 handoff,
19.5 drain) the launches of every kernel and the batches the batchers
formed (``reporter_microbatch_batches_total``).  Then phase 20 once
(``observability_phase``; phase 17's kernel times are not taken, so its
ratios read "-").  Prints the card's name and power limit, one ``split``
line per run and writes chiprun_out/adaptive_split.json.  On host cores
(``--device cpu``, a 24 x 24 city) the launch counts read 0 and phase 19
runs without its card-only checks.
"""

import argparse
import json
import os
import subprocess
import sys
import time

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)

import chip_smoke as CS  # noqa: E402


def _steps(served, t64, t256, t1024, device):
    """Phase 19's steps in order: (name, launches {kernel: n}, batches)."""
    from reporter_tpu_torch.serve import service as service_mod

    cfg_json, sv, second = served
    out = []

    def run(name, fn):
        b0 = service_mod.C_BATCHES.value
        res = fn()
        launches = res[1] if isinstance(res, tuple) else {}
        runs = list(launches.values()) if launches and isinstance(
            next(iter(launches.values())), dict) else [launches]
        total = {}
        for r in runs:
            for k, n in r.items():
                total[k] = total.get(k, 0) + n
        out.append((name, total, int(service_mod.C_BATCHES.value - b0)))

    run("19.1", lambda: CS.recovery_faults_off(sv, second, t64, t256, t1024))
    run("19.2", lambda: CS.recovery_poison(sv, second, t64))
    run("19.3", lambda: CS.recovery_watchdog(sv, second, t64, device))
    run("19.4", lambda: CS.recovery_handoff(sv, second, t64))
    run("19.5", lambda: CS.recovery_drain(cfg_json, second, t1024, device))
    CS._RECOVERY_BASE.append(CS.recovery_counts())
    return out


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--rows", type=int, default=120)
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--rounds", type=int, default=1)
    args = ap.parse_args(argv)
    import torch

    from reporter_tpu_torch import faults

    device = torch.device(args.device)
    card = ""
    if device.type == "cuda":
        card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                               "--format=csv,noheader"], capture_output=True, text=True,
                              timeout=60, check=True).stdout.strip().splitlines()[0]
        print(card)
        CS.build()
    scale = 1 if args.rows >= 120 else 4
    t0 = time.perf_counter()
    _matcher, net, _info = CS.osm_city(args.rows, device)
    short, med, long_ = CS.osm_cohorts(_matcher.arrays, scale)
    t64, t256, t1024 = ([s.trace for s in c] for c in (short, med, long_))
    _launches, net_json, tiles = CS.osm_serve_phase(net, args.rows, t64, device)
    _wi, _wl, served = CS.wire_phase(net_json, tiles, t64, t256, t1024, device, card)
    print("set-up %.1f s" % (time.perf_counter() - t0))
    runs = []
    prev = os.environ.get("REPORTER_ADAPTIVE")
    try:
        for _ in range(max(1, args.rounds)):
            for flag in ("0", "1", "1", "0"):
                os.environ["REPORTER_ADAPTIVE"] = flag
                t1 = time.perf_counter()
                steps = _steps(served, t64, t256, t1024, device)
                faults.reset()
                wall = time.perf_counter() - t1
                sweeps = sum(s[1].get("candidate_sweep", 0) for s in steps)
                runs.append({"adaptive": flag, "wall_s": wall, "sweeps": sweeps,
                             "steps": [{"step": n, "launches": ln, "batches": nb}
                                       for n, ln, nb in steps]})
                print("split adaptive=%s: phase 19 %.1f s, %d sweep launches; per step %s"
                      % (flag, wall, sweeps, "; ".join(
                          "%s sweeps %d, batches %d" % (n, ln.get("candidate_sweep", 0), nb)
                          for n, ln, nb in steps)))
    finally:
        if prev is None:
            os.environ.pop("REPORTER_ADAPTIVE", None)
        else:
            os.environ["REPORTER_ADAPTIVE"] = prev
    obs = CS.observability_phase(served[1], t64, t256, {}, device, card)
    out_dir = os.path.join(REPO, "chiprun_out")
    os.makedirs(out_dir, exist_ok=True)
    with open(os.path.join(out_dir, "adaptive_split.json"), "w") as f:
        json.dump({"card": card, "rows": args.rows, "runs": runs,
                   "observability": obs}, f, indent=1, default=str)
    print(json.dumps({"ok": True, "runs": len(runs)}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
