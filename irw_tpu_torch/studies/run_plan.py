"""Study sweeps (port of ``studies/run_plan.py:32-164``)::

    python -m irw_tpu_torch.studies.run_plan studies/voc_lambda_protocol.yaml [--dry-run]
        [--jobs N] [--chips-per-job 1] [--retries R]

A plan (``study_name``, ``base_overrides``, ``sweep`` of key → values) expands
into one ``irw_tpu_torch.single_experiment_runner`` job per combination of
the swept values, each named from them.  Each job runs in its own process;
``--retries`` re-runs the failed ones (with ``experience.maybe_resume=true``
a retried job resumes).  ``--jobs N`` runs up to N jobs at once in lanes
taken from a free pool (a lane goes back to the pool when its job ends, so
a job finishing out of order never leaves two jobs on one card); with
``--chips-per-job 1`` each lane's job sees only its card,
``CUDA_VISIBLE_DEVICES=<lane>`` (JAX's ``TPU_VISIBLE_DEVICES``), and
without it no variable is set.  A job over several cards trains over a
process group, which waits for ROADMAP A13b.
"""

from __future__ import annotations

import argparse
import itertools
import os
import subprocess
import sys
import time

from irw_tpu_torch.config.yaml_lite import load

REPO_ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
POLL_SECONDS = 0.5   # how often a full pool looks for an ended job


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


def check_chips_per_job(chips_per_job: int | None) -> None:
    if chips_per_job is not None and chips_per_job > 1:
        raise NotImplementedError(
            f"--chips-per-job {chips_per_job}: a job over several cards trains over a process "
            "group, which waits for ROADMAP A13b")


def _job_line(lane: int, n_parallel: int, chips_per_job: int | None, cmd) -> str:
    pin = f"CUDA_VISIBLE_DEVICES={lane} " if chips_per_job else ""
    where = f"[lane {lane}] " if n_parallel > 1 else ""
    return f"  {where}{pin}{' '.join(cmd)}"


def run_jobs(jobs, n_parallel: int = 1, chips_per_job: int | None = None,
             dry_run: bool = False) -> list:
    """Run the jobs, each in its own process, up to ``n_parallel`` at a time
    (in turn with 1); the failed ones as (name, overrides).  A job takes a
    lane from the free pool when it starts and gives it back when it ends."""
    check_chips_per_job(chips_per_job)
    by_name = dict(jobs)
    failed: list[tuple[str, list]] = []
    running: list[tuple[subprocess.Popen, str, int]] = []
    free_lanes = list(range(max(n_parallel, 1)))

    def finished(name: str, rc: int) -> None:
        if rc != 0:
            print(f"  job {name} FAILED (rc={rc})", flush=True)
            failed.append((name, by_name[name]))

    def reap(block: bool) -> None:
        """Collect the ended jobs (with ``block``, all of them)."""
        for item in list(running):
            proc, name, lane = item
            rc = proc.wait() if block else proc.poll()
            if rc is None:
                continue
            finished(name, rc)
            running.remove(item)
            free_lanes.append(lane)

    for i, (name, overrides) in enumerate(jobs):
        cmd = build_command(overrides)
        if dry_run:  # the lane each job would take if the jobs ended in order
            print(_job_line(i % len(free_lanes), n_parallel, chips_per_job, cmd), flush=True)
            continue
        while not free_lanes:
            reap(block=False)
            if not free_lanes:
                time.sleep(POLL_SECONDS)
        lane = free_lanes.pop(0)
        print(_job_line(lane, n_parallel, chips_per_job, cmd), flush=True)
        env = dict(os.environ)
        if chips_per_job:   # the lane's card alone (JAX: TPU_VISIBLE_DEVICES)
            env["CUDA_VISIBLE_DEVICES"] = str(lane)
        running.append((subprocess.Popen(cmd, cwd=REPO_ROOT, env=env), name, lane))
    reap(block=True)
    return failed


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("plan")
    parser.add_argument("--dry-run", action="store_true")
    parser.add_argument("--jobs", type=int, default=1, help="run up to N jobs at once")
    parser.add_argument("--chips-per-job", type=int, default=None,
                        help="pin each parallel job to its own card (1; more waits for A13b)")
    parser.add_argument("--retries", type=int, default=1,
                        help="re-run failed jobs up to N extra passes")
    args = parser.parse_args(argv)
    check_chips_per_job(args.chips_per_job)
    plan = load_plan(args.plan)
    jobs = expand_jobs(plan)
    print(f"study '{plan.get('study_name')}': {len(jobs)} jobs"
          + (f", {args.jobs} in parallel" if args.jobs > 1 else ""), flush=True)
    pending = jobs
    for attempt in range(args.retries + 1):
        if attempt:
            print(f"retry pass {attempt}/{args.retries}: {len(pending)} failed job(s)",
                  flush=True)
        pending = run_jobs(pending, n_parallel=args.jobs, chips_per_job=args.chips_per_job,
                           dry_run=args.dry_run)
        if not pending or args.dry_run:
            break
    if pending:
        print(f"{len(pending)} job(s) still failing after {args.retries} retry pass(es): "
              + ", ".join(name for name, _ in pending), flush=True)
        return 1
    return 0


if __name__ == "__main__":
    sys.exit(main())
