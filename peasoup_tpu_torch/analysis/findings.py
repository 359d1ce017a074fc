"""Findings and the ratchet baseline.

A :class:`Finding` is one rule violation (AST or contract engine). Its
**fingerprint** is content-addressed — ``rule | path | stripped source
line`` — so baselined findings survive unrelated edits that shift line
numbers, and move WITH the offending line when it is cut/pasted. Two
identical lines in one file share a fingerprint; the baseline stores a
count per fingerprint, so adding a second copy of a baselined hazard
still fails the gate.

The :class:`Baseline` is a checked-in JSON document
(``peasoup_tpu_torch/analysis/audit_baseline.json``). The ratchet: findings covered by the
baseline are reported but don't fail; anything new does; baseline
entries that no longer match are reported as *resolved* so the file
can be re-written smaller (``peasoup-audit --write-baseline``) —
debt only goes down.
"""

from __future__ import annotations

import hashlib
import json
import os
import tempfile
from dataclasses import dataclass, field

BASELINE_SCHEMA = "peasoup_tpu_torch.audit_baseline"
BASELINE_VERSION = 1

SEV_ERROR = "error"
SEV_WARNING = "warning"


@dataclass
class Finding:
    """One rule violation."""

    rule: str  # rule ID, e.g. "PSA001" / "PSC101"
    severity: str  # "error" | "warning"
    path: str  # repo-relative posix path, or "ops-registry/<name>"
    line: int  # 1-based; 0 for whole-program (contract) findings
    col: int  # 0-based
    message: str
    fix_hint: str = ""
    source_line: str = ""  # stripped offending line (fingerprint input)
    baselined: bool = False

    @property
    def fingerprint(self) -> str:
        key = f"{self.rule}|{self.path}|{self.source_line.strip()}"
        return hashlib.sha1(key.encode()).hexdigest()[:16]

    def to_json(self) -> dict:
        return {
            "rule": self.rule,
            "severity": self.severity,
            "path": self.path,
            "line": self.line,
            "col": self.col,
            "message": self.message,
            "fix_hint": self.fix_hint,
            "fingerprint": self.fingerprint,
            "baselined": self.baselined,
        }

    def render(self) -> str:
        loc = f"{self.path}:{self.line}" if self.line else self.path
        tag = " (baselined)" if self.baselined else ""
        out = f"{loc}: {self.rule} [{self.severity}]{tag}: {self.message}"
        if self.fix_hint:
            out += f"\n    hint: {self.fix_hint}"
        return out


def _atomic_write_json(path: str, doc: dict) -> None:
    d = os.path.dirname(os.path.abspath(path))
    fd, tmp = tempfile.mkstemp(dir=d, suffix=".tmp")
    try:
        with os.fdopen(fd, "w") as f:
            json.dump(doc, f, indent=2, sort_keys=True)
            f.write("\n")
        os.replace(tmp, path)
    except BaseException:
        try:
            os.unlink(tmp)
        except OSError:
            pass
        raise


@dataclass
class Baseline:
    """Fingerprint -> tolerated count."""

    fingerprints: dict[str, int] = field(default_factory=dict)

    @classmethod
    def _load_strict(cls, path: str) -> "Baseline":
        with open(path) as f:
            doc = json.load(f)
        if doc.get("schema") != BASELINE_SCHEMA:
            raise ValueError(
                f"{path}: not a {BASELINE_SCHEMA} document "
                f"(schema={doc.get('schema')!r})"
            )
        fps = doc.get("fingerprints", {})
        if not isinstance(fps, dict) or not all(
            isinstance(v, int) and v > 0 for v in fps.values()
        ):
            raise ValueError(f"{path}: fingerprints must map fp -> count > 0")
        return cls(fingerprints=dict(fps))

    @classmethod
    def load(cls, path: str) -> "Baseline":
        """Unified corrupt-artifact semantics (resilience policy):
        warn + structured event on damage, but no quarantine rename
        (checked-in file) and no silent empty default — an unreadable
        baseline must fail the audit gate as an internal error, not
        ratchet every existing finding in as new."""
        from ..resilience import load_or_recover

        out = load_or_recover(
            path, cls._load_strict, default=None, kind="audit baseline",
            action="failing the audit gate", quarantine=False,
        )
        if out is None:
            raise ValueError(
                f"{path}: not a readable {BASELINE_SCHEMA} baseline "
                "(missing or corrupt; re-pin with peasoup-audit "
                "--write-baseline)"
            )
        return out

    @classmethod
    def from_findings(cls, findings) -> "Baseline":
        fps: dict[str, int] = {}
        for f in findings:
            fps[f.fingerprint] = fps.get(f.fingerprint, 0) + 1
        return cls(fingerprints=fps)

    def save(self, path: str) -> None:
        _atomic_write_json(
            path,
            {
                "schema": BASELINE_SCHEMA,
                "version": BASELINE_VERSION,
                "generated_by": "peasoup-audit --write-baseline",
                "fingerprints": self.fingerprints,
            },
        )

    def apply(self, findings) -> tuple[list, list, list]:
        """Split findings into (new, baselined) and return the list of
        resolved fingerprints (baseline entries with fewer live matches
        than their tolerated count). Findings are mutated in place
        (``baselined`` flag); within one fingerprint the first matches
        are baselined, the surplus is new."""
        budget = dict(self.fingerprints)
        new, old = [], []
        for f in findings:
            fp = f.fingerprint
            if budget.get(fp, 0) > 0:
                budget[fp] -= 1
                f.baselined = True
                old.append(f)
            else:
                new.append(f)
        resolved = sorted(fp for fp, n in budget.items() if n > 0)
        return new, old, resolved
