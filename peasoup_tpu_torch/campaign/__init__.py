"""Campaign orchestration: run the port's pipelines over many
observations (the port's copy of the JAX package's campaign/, the same
directory layout, record formats and schema names, so a campaign
directory is served and read by either package's tools).

- :mod:`.queue` — a file-backed job queue, safe for many workers on a
  shared filesystem: atomic claim files, lease expiry + stale-claim
  reaping (a SIGKILLed worker's job is re-queued), per-job retry with
  exponential backoff, quarantine after the retry budget, priorities,
  preempt requests and gang claims.
- :mod:`.registry`, :mod:`.autoscale` — fleet membership and the
  controller that grows and shrinks it.
- :mod:`.tenants`, :mod:`.usage`, :mod:`.ingest` — tenant quotas, the
  usage ledger and the submission front end.
- :mod:`.runner` — the long-lived worker loop: orders jobs into shape
  buckets (:mod:`.buckets`) so consecutive observations reuse the
  loaded kernels and tuned plans, runs each job with its own
  live-observability stack under the job dir, and records the kernel
  libraries each job built.
- :mod:`.db` — the survey-level candidate database (stdlib sqlite).
- :mod:`.rollup` — the atomically rewritten ``campaign_status.json``;
  ``python -m peasoup_tpu_torch.tools.watch`` renders it.

Entry point: ``python -m peasoup_tpu_torch.cli.campaign``.
"""

from .db import CandidateDB
from .queue import Claim, Job, JobQueue
from .rollup import CAMPAIGN_SCHEMA, build_status, write_status
from .runner import CampaignRunner, load_campaign_config

__all__ = [
    "CAMPAIGN_SCHEMA",
    "CandidateDB",
    "CampaignRunner",
    "Claim",
    "Job",
    "JobQueue",
    "build_status",
    "load_campaign_config",
    "write_status",
]
