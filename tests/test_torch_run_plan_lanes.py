"""``irw_tpu_torch.studies.run_plan``'s parallel lanes (port of
``studies/run_plan.py:60-125``), with a fake job command that records the
card it was pinned to: lanes come from a free pool (a job that ends out of
order frees its lane for the next), ``--chips-per-job 1`` pins a lane's job
by ``CUDA_VISIBLE_DEVICES``, no variable is set without it, ``--jobs 1``
runs the jobs in turn, failed jobs come back for the retry pass, and a job
over several cards names ROADMAP A13b."""

import torch_threads  # noqa: F401  (first: one PyTorch thread a worker)
import json
import sys

import pytest

from irw_tpu_torch.studies import run_plan

# a job: sleeps, then appends {name, card, start, end} to the log; exits 1
# when its overrides ask it to fail, or to fail the first time only
JOB = """
import json, os, sys, time
name, sleep, log, fail = sys.argv[1], float(sys.argv[2]), sys.argv[3], sys.argv[4]
start = time.time()
time.sleep(sleep)
with open(log, "a") as f:
    f.write(json.dumps({"name": name, "card": os.environ.get("CUDA_VISIBLE_DEVICES"),
                        "start": start, "end": time.time()}) + "\\n")
marker = log + "." + name
if fail == "always" or (fail == "once" and not os.path.exists(marker)):
    open(marker, "w").close()
    sys.exit(1)
"""


@pytest.fixture()
def fake_jobs(monkeypatch, tmp_path):
    """(make jobs, read the log): a job is (name, [sleep seconds, fail])."""
    log = tmp_path / "jobs.jsonl"
    monkeypatch.delenv("CUDA_VISIBLE_DEVICES", raising=False)
    monkeypatch.setattr(run_plan, "build_command", lambda overrides: [
        sys.executable, "-c", JOB, overrides[0], overrides[1], str(log), overrides[2]])

    def jobs(*specs):
        return [(name, [name, str(sleep), fail]) for name, sleep, fail in specs]

    def read():
        if not log.exists():
            return []
        return [json.loads(line) for line in log.read_text().splitlines()]
    return jobs, read


def test_a_freed_lane_takes_the_next_job(fake_jobs):
    """a holds lane 0; b ends first, so c takes lane 1, not a's busy lane."""
    jobs, read = fake_jobs
    failed = run_plan.run_jobs(jobs(("a", 1.5, "no"), ("b", 0.1, "no"), ("c", 0.1, "no")),
                               n_parallel=2, chips_per_job=1)
    assert failed == []
    records = {r["name"]: r for r in read()}
    assert {name: r["card"] for name, r in records.items()} == {"a": "0", "b": "1", "c": "1"}
    assert records["c"]["start"] < records["a"]["end"]   # ran beside a


def test_lanes_set_no_card_without_chips_per_job(fake_jobs):
    jobs, read = fake_jobs
    assert run_plan.run_jobs(jobs(("a", 0.2, "no"), ("b", 0.2, "no")), n_parallel=2) == []
    records = read()
    assert sorted(r["name"] for r in records) == ["a", "b"]
    assert all(r["card"] is None for r in records)
    a, b = sorted(records, key=lambda r: r["name"])
    assert b["start"] < a["end"] and a["start"] < b["end"]   # at once


def test_one_job_at_a_time_runs_in_turn(fake_jobs):
    jobs, read = fake_jobs
    assert run_plan.run_jobs(jobs(("a", 0.2, "no"), ("b", 0.1, "no")), n_parallel=1,
                             chips_per_job=1) == []
    a, b = read()
    assert (a["name"], b["name"]) == ("a", "b") and a["end"] <= b["start"]
    assert a["card"] == b["card"] == "0"


def test_failed_jobs_come_back_and_the_retry_pass_reruns_them(fake_jobs, monkeypatch, capsys):
    jobs, read = fake_jobs
    specs = jobs(("ok", 0.05, "no"), ("flaky", 0.05, "once"), ("bad", 0.05, "always"))
    failed = run_plan.run_jobs(specs, n_parallel=3, chips_per_job=1)
    assert sorted(name for name, _ in failed) == ["bad", "flaky"]
    assert dict(failed)["bad"] == dict(specs)["bad"]
    # main: its retry pass reruns the failed job, in a lane again
    monkeypatch.setattr(run_plan, "load_plan", lambda path: {"study_name": "s"})
    monkeypatch.setattr(run_plan, "expand_jobs",
                        lambda plan: jobs(("ok", 0.05, "no"), ("flaky2", 0.05, "once")))
    before = len(read())
    assert run_plan.main(["plan.yaml", "--jobs", "2", "--chips-per-job", "1",
                          "--retries", "1"]) == 0
    ran = read()[before:]
    assert sorted(r["name"] for r in ran) == ["flaky2", "flaky2", "ok"]
    assert all(r["card"] in ("0", "1") for r in ran)
    out = capsys.readouterr().out
    assert "2 in parallel" in out and "retry pass 1/1: 1 failed job(s)" in out


@pytest.mark.parametrize("call", ["run_jobs", "main"])
def test_several_cards_a_job_name_a13b(fake_jobs, call):
    jobs, read = fake_jobs
    with pytest.raises(NotImplementedError, match="A13b"):
        if call == "run_jobs":
            run_plan.run_jobs(jobs(("a", 0.0, "no")), n_parallel=2, chips_per_job=2)
        else:
            run_plan.main(["studies/voc_lambda_protocol.yaml", "--dry-run", "--jobs", "2",
                           "--chips-per-job", "2"])
    assert read() == []   # refused before any job started
