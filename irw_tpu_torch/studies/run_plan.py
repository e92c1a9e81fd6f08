"""Study sweeps (port of ``studies/run_plan.py:32-164``)::

    python -m irw_tpu_torch.studies.run_plan studies/voc_lambda_protocol.yaml [--dry-run]

A plan (``study_name``, ``base_overrides``, ``sweep`` of key → values) expands
into one ``irw_tpu_torch.single_experiment_runner`` job per combination of
the swept values, each named from them.  The jobs run one after another on
the card, each in its own process; ``--retries`` re-runs the failed ones
(with ``experience.maybe_resume=true`` a retried job resumes).  Jobs in
parallel over several cards (``--jobs``, ``--chips-per-job``) wait for
ROADMAP A13.
"""

from __future__ import annotations

import argparse
import itertools
import os
import subprocess
import sys

from irw_tpu_torch.config.yaml_lite import load

REPO_ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def load_plan(path: str) -> dict:
    return load(path)


def expand_jobs(plan: dict):
    """[(name, overrides)], one a combination of the sweep's values."""
    base = list(plan.get("base_overrides") or [])
    sweep = plan.get("sweep") or {}
    keys = sorted(sweep)
    study = plan.get("study_name", "study")
    jobs = []
    for combo in itertools.product(*(sweep[k] for k in keys)):
        overrides = base + [f"{k}={v}" for k, v in zip(keys, combo)]
        name_bits = [f"{k.split('.')[-1]}={v}" for k, v in zip(keys, combo)]
        name = f"{study}_" + "_".join(name_bits) if name_bits else study
        overrides.append(f"experience.experiment_name={name}")
        jobs.append((name, overrides))
    return jobs


def build_command(overrides) -> list[str]:
    return [sys.executable, "-m", "irw_tpu_torch.single_experiment_runner"] + list(overrides)


def run_jobs(jobs, dry_run: bool = False) -> list:
    """Run the jobs in turn; the failed ones as (name, overrides)."""
    failed = []
    for name, overrides in jobs:
        cmd = build_command(overrides)
        print(" ", " ".join(cmd), flush=True)
        if dry_run:
            continue
        rc = subprocess.run(cmd, cwd=REPO_ROOT, check=False).returncode
        if rc != 0:
            print(f"  job {name} FAILED (rc={rc})", flush=True)
            failed.append((name, overrides))
    return failed


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("plan")
    parser.add_argument("--dry-run", action="store_true")
    parser.add_argument("--jobs", type=int, default=1)
    parser.add_argument("--chips-per-job", type=int, default=None)
    parser.add_argument("--retries", type=int, default=1,
                        help="re-run failed jobs up to N extra passes")
    args = parser.parse_args(argv)
    if args.jobs > 1 or args.chips_per_job:
        raise NotImplementedError("jobs in parallel over several cards (--jobs, "
                                  "--chips-per-job) wait for ROADMAP A13")
    plan = load_plan(args.plan)
    jobs = expand_jobs(plan)
    print(f"study '{plan.get('study_name')}': {len(jobs)} jobs", flush=True)
    pending = jobs
    for attempt in range(args.retries + 1):
        if attempt:
            print(f"retry pass {attempt}/{args.retries}: {len(pending)} failed job(s)",
                  flush=True)
        pending = run_jobs(pending, dry_run=args.dry_run)
        if not pending or args.dry_run:
            break
    if pending:
        print(f"{len(pending)} job(s) still failing after {args.retries} retry pass(es): "
              + ", ".join(name for name, _ in pending), flush=True)
        return 1
    return 0


if __name__ == "__main__":
    sys.exit(main())
