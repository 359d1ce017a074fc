"""Candidate diagnostic plots: the port's copy of the JAX package's
tools/plotting.py.

``CandidatePlotter`` draws the full diagnostic sheet of the reference's
CandidatePlotter (reference: tools/peasoup_tools.py:167-383): pulse
profile over two phase turns, folded subintegrations image with a
per-subint statistics side panel, a parameter table, per-harmonic DM-S/N
and acc-S/N scatters, the DM-acceleration plane sized by S/N, and an
all-candidate period-DM overview with a crosshair on the plotted
candidate. It needs matplotlib, imported only when a sheet is drawn: where
matplotlib is not installed, drawing raises the ImportError of ``import
matplotlib``, which names it. The DM-time bowtie (``render_bowtie_svg``
and its readers) is numpy and SVG text and needs nothing else.
"""

from __future__ import annotations

import numpy as np

_HARM_COLORS = ("#1f3d7a", "#7aa6d9", "#2e8b57", "#e08a2e", "#8b1a1a")


def _radec_str(v: float, hours: bool) -> str:
    """Sigproc packed ddmmss.s / hhmmss.s float to a display string."""
    sign = "-" if v < 0 else ""
    v = abs(v)
    d = int(v // 10000)
    m = int((v - d * 10000) // 100)
    s = v - d * 10000 - m * 100
    unit = "h" if hours else "d"
    return f"{sign}{d:02d}{unit}{m:02d}m{s:05.2f}s"


class CandidatePlotter:
    """Render one candidate's full diagnostic sheet from an
    overview.xml + candidates.peasoup pair."""

    def __init__(self, overview, cand_file_parser):
        self.overview = overview
        self.parser = cand_file_parser

    # ---- panel painters -------------------------------------------------

    def _profile(self, ax, fold):
        prof = fold.sum(axis=0)
        ax.plot(np.r_[prof, prof], color="#1f3d7a", lw=1.2)
        ax.axvline(len(prof) - 0.5, color="0.8", lw=0.8)
        ax.set_title("Profile (2 turns)")
        ax.set_xlim(0, 2 * len(prof) - 1)
        ax.tick_params(labelbottom=False, labelleft=False)

    def _subints(self, ax, fold):
        ax.imshow(
            np.r_[fold.T, fold.T].T, aspect="auto", origin="lower",
            interpolation="nearest", cmap="viridis",
        )
        ax.set_xlabel("Phase bin (2 turns)")
        ax.set_ylabel("Subintegration")

    def _subint_stats(self, ax, fold):
        y = np.arange(fold.shape[0])
        mean = fold.mean(axis=1)
        std = fold.std(axis=1)
        ax.fill_betweenx(
            y, mean - 3 * std, mean + 3 * std, alpha=0.4,
            color="#7aa6d9", label="±3σ",
        )
        ax.plot(mean, y, color="#1f3d7a", lw=1.5, label="mean")
        ax.plot(fold.max(axis=1), y, color="#8b1a1a", lw=1.0, label="max")
        ax.invert_xaxis()
        ax.set_ylim(-0.5, fold.shape[0] - 0.5)
        ax.set_title("Subint stats", fontsize=9)
        ax.legend(fontsize=6, loc="upper left")
        ax.tick_params(labelbottom=False)

    def _table(self, ax, cand):
        hdr = self.overview.header
        rows = [
            ("R.A.", _radec_str(float(hdr.get("src_raj", 0) or 0), True)),
            ("Decl.", _radec_str(float(hdr.get("src_dej", 0) or 0), False)),
            ("P0 (s)", f"{cand['period']:.9f}"),
            ("Opt P0 (s)", f"{cand['opt_period']:.9f}"),
            ("DM", f"{cand['dm']:.2f}"),
            ("Acc (m/s²)", f"{cand['acc']:.2f}"),
            ("Harmonic", str(int(cand["nh"]))),
            ("Spec S/N", f"{cand['snr']:.1f}"),
            ("Fold S/N", f"{cand['folded_snr']:.1f}"),
            ("Adjacent?", str(bool(cand["is_adjacent"]))),
            ("Physical?", str(bool(cand["is_physical"]))),
            ("DDM count ratio", f"{cand['ddm_count_ratio']:.3f}"),
            ("DDM S/N ratio", f"{cand['ddm_snr_ratio']:.3f}"),
            ("N assoc", str(int(cand["nassoc"]))),
        ]
        ax.axis("off")
        tab = ax.table(
            cellText=rows, cellLoc="left", loc="center",
            colWidths=[0.62, 0.55],
        )
        tab.auto_set_font_size(False)
        tab.set_fontsize(9)
        tab.scale(1.0, 1.4)
        for cell in tab.get_celld().values():
            cell.set_linewidth(0)

    def _by_harm(self, ax, hits, xfield, yfield, flip=False):
        for i, nh in enumerate(np.unique(hits["nh"])):
            sub = hits[hits["nh"] == nh]
            ax.scatter(
                sub[xfield], sub[yfield], s=10,
                color=_HARM_COLORS[int(nh) % len(_HARM_COLORS)],
                label=f"harm {int(nh)}", edgecolors="none",
            )
        if flip:
            ax.yaxis.tick_right()
            ax.yaxis.set_label_position("right")
        ax.set_xlabel(xfield)
        ax.set_ylabel(yfield)
        ax.legend(fontsize=6)

    def _dm_acc_plane(self, ax, hits):
        snr = hits["snr"].astype(float)
        span = snr.max() - snr.min()
        sizes = 5 + 120 * (snr - snr.min()) / (span if span else 1.0)
        for i, nh in enumerate(np.unique(hits["nh"])):
            m = hits["nh"] == nh
            ax.scatter(
                hits["dm"][m], hits["acc"][m], s=sizes[m],
                color=_HARM_COLORS[int(nh) % len(_HARM_COLORS)],
                alpha=0.7, edgecolors="none",
            )
        ax.set_xlabel("DM (pc cm$^{-3}$)")
        ax.set_ylabel("Acc (m/s²)")
        ax.set_title("DM-acc plane (size ∝ S/N)", fontsize=9)

    def _all_cands(self, ax, cand):
        """Period-DM overview of the WHOLE candidate list with a
        crosshair on the plotted candidate."""
        c = self.overview.candidates
        ax.set_xscale("log")
        ax.scatter(
            c["period"], c["dm"], s=np.clip(c["snr"], 5, 120),
            c=[_HARM_COLORS[int(n) % len(_HARM_COLORS)] for n in c["nh"]],
            alpha=0.7, edgecolors="none",
        )
        ax.axvline(float(cand["period"]), color="0.3", lw=0.8)
        ax.axhline(float(cand["dm"]), color="0.3", lw=0.8)
        ax.set_xlabel("Period (s)")
        ax.set_ylabel("DM (pc cm$^{-3}$)")
        ax.set_title("All candidates (crosshair = this one)", fontsize=9)

    # ---- entry point ----------------------------------------------------

    def plot(self, idx: int, outfile: str | None = None):
        import matplotlib

        if outfile:
            matplotlib.use("Agg")
        import matplotlib.pyplot as plt
        from matplotlib import gridspec

        cand = self.overview.candidates[idx]
        rec = self.parser.read_candidate(int(cand["byte_offset"]))

        fig = plt.figure(figsize=(14, 12))
        gs = gridspec.GridSpec(
            4, 6, figure=fig, hspace=0.55, wspace=0.65,
            height_ratios=[1.0, 1.2, 1.2, 1.6],
        )
        fig.suptitle(
            f"{self.overview.header.get('source_name', 'unknown')} — "
            f"candidate {idx}: P={cand['period']:.6f} s  "
            f"DM={cand['dm']:.2f}  acc={cand['acc']:.2f}  "
            f"S/N={cand['snr']:.1f}",
            fontsize=13,
        )

        ax_prof = fig.add_subplot(gs[0, 1:3])
        ax_fold = fig.add_subplot(gs[1:3, 1:3])
        ax_stats = fig.add_subplot(gs[1:3, 0])
        ax_table = fig.add_subplot(gs[0:3, 3])
        ax_dm = fig.add_subplot(gs[0, 4:6])
        ax_dmacc = fig.add_subplot(gs[1:3, 4])
        ax_acc = fig.add_subplot(gs[1:3, 5])
        ax_all = fig.add_subplot(gs[3, :])

        fold = rec["fold"]
        if fold is not None and fold.size:
            f = fold.astype(float)
            span = f.max() - f.min()
            f = (f - f.min()) / (span if span else 1.0)
            self._profile(ax_prof, f)
            self._subints(ax_fold, f)
            self._subint_stats(ax_stats, f)
        else:
            for ax in (ax_prof, ax_fold, ax_stats):
                ax.text(0.5, 0.5, "no fold", ha="center", va="center")
                ax.axis("off")

        self._table(ax_table, cand)

        hits = rec["hits"]
        if len(hits):
            self._by_harm(ax_dm, hits, "dm", "snr", flip=True)
            self._by_harm(ax_acc, hits, "snr", "acc", flip=True)
            self._dm_acc_plane(ax_dmacc, hits)
        self._all_cands(ax_all, cand)

        if outfile:
            fig.savefig(outfile, dpi=100, bbox_inches="tight")
            plt.close(fig)
            return outfile
        return fig


# --------------------------------------------------------------------------
# DM-time bowtie / waterfall diagnostic (self-contained SVG, no matplotlib)
# --------------------------------------------------------------------------

def render_bowtie_svg(
    times_s,
    dms,
    snrs,
    widths=None,
    title: str = "DM-time bowtie",
    width_px: int = 920,
    height_px: int = 430,
    min_snr: float = 0.0,
) -> str:
    """The classic single-pulse diagnostic: every detection scattered
    in (time, DM) with marker area scaling with S/N. A real dispersed
    pulse traces the bowtie (S/N peaking at the true DM and fading
    symmetrically above/below); RFI stripes the DM axis at constant
    time. Pure-SVG by construction — no matplotlib, so the plot can be
    generated headless and embedded verbatim in the sift HTML report.
    """
    times = np.asarray(times_s, dtype=float)
    dms = np.asarray(dms, dtype=float)
    snrs = np.asarray(snrs, dtype=float)
    keep = snrs >= float(min_snr)
    times, dms, snrs = times[keep], dms[keep], snrs[keep]
    widths_arr = (
        np.asarray(widths)[keep] if widths is not None else None
    )
    ml, mr, mt, mb = 64, 18, 34, 46  # margins
    pw, ph = width_px - ml - mr, height_px - mt - mb
    parts = [
        f'<svg xmlns="http://www.w3.org/2000/svg" width="{width_px}" '
        f'height="{height_px}" viewBox="0 0 {width_px} {height_px}" '
        f'font-family="system-ui, sans-serif">',
        f'<rect width="{width_px}" height="{height_px}" fill="#ffffff"/>',
        f'<rect x="{ml}" y="{mt}" width="{pw}" height="{ph}" '
        f'fill="#f8f9fb" stroke="#c8ccd4"/>',
        f'<text x="{ml}" y="20" font-size="14" fill="#1a1a2e">'
        f"{_esc(title)} — {times.size} events</text>",
    ]
    if times.size == 0:
        parts.append(
            f'<text x="{ml + pw / 2:.0f}" y="{mt + ph / 2:.0f}" '
            f'font-size="13" fill="#666" text-anchor="middle">'
            "no single-pulse events</text></svg>"
        )
        return "".join(parts)
    t0, t1 = float(times.min()), float(times.max())
    d0, d1 = float(dms.min()), float(dms.max())
    tspan = (t1 - t0) or 1.0
    dspan = (d1 - d0) or 1.0
    s0, s1 = float(snrs.min()), float(snrs.max())
    sspan = (s1 - s0) or 1.0

    def _x(t: float) -> float:
        return ml + (t - t0) / tspan * pw

    def _y(d: float) -> float:
        return mt + ph - (d - d0) / dspan * ph

    # axes: 5 ticks each
    for i in range(6):
        tx = t0 + tspan * i / 5.0
        x = _x(tx)
        parts.append(
            f'<line x1="{x:.1f}" y1="{mt + ph}" x2="{x:.1f}" '
            f'y2="{mt + ph + 4}" stroke="#888"/>'
            f'<text x="{x:.1f}" y="{mt + ph + 17}" font-size="10" '
            f'fill="#444" text-anchor="middle">{tx:.3g}</text>'
        )
        dv = d0 + dspan * i / 5.0
        y = _y(dv)
        parts.append(
            f'<line x1="{ml - 4}" y1="{y:.1f}" x2="{ml}" y2="{y:.1f}" '
            f'stroke="#888"/>'
            f'<text x="{ml - 7}" y="{y + 3:.1f}" font-size="10" '
            f'fill="#444" text-anchor="end">{dv:.4g}</text>'
        )
    parts.append(
        f'<text x="{ml + pw / 2:.0f}" y="{height_px - 10}" '
        f'font-size="11" fill="#1a1a2e" text-anchor="middle">'
        "Time (s)</text>"
        f'<text x="14" y="{mt + ph / 2:.0f}" font-size="11" '
        f'fill="#1a1a2e" text-anchor="middle" '
        f'transform="rotate(-90 14 {mt + ph / 2:.0f})">'
        "DM (pc cm&#8315;&#179;)</text>"
    )
    # strongest drawn last (on top); radius grows with S/N
    order = np.argsort(snrs)
    for i in order:
        r = 1.5 + 6.5 * (snrs[i] - s0) / sspan
        extra = (
            f"w={int(widths_arr[i])} " if widths_arr is not None else ""
        )
        parts.append(
            f'<circle cx="{_x(times[i]):.1f}" cy="{_y(dms[i]):.1f}" '
            f'r="{r:.2f}" fill="#2563eb" fill-opacity="0.45" '
            f'stroke="none"><title>t={times[i]:.4f}s DM={dms[i]:.2f} '
            f"S/N={snrs[i]:.1f} {extra}</title></circle>"
        )
    parts.append(
        f'<text x="{width_px - mr}" y="20" font-size="10" fill="#666" '
        f'text-anchor="end">S/N {s0:.1f}&#8211;{s1:.1f} '
        "(area &#8733; S/N)</text></svg>"
    )
    return "".join(parts)


def _esc(s: str) -> str:
    return (
        str(s).replace("&", "&amp;").replace("<", "&lt;")
        .replace(">", "&gt;")
    )


def bowtie_from_singlepulse(path: str, **kw) -> str:
    """Bowtie SVG from a ``.singlepulse`` text table
    (io.output.write_singlepulse / tools.parsers.read_singlepulse)."""
    from .parsers import read_singlepulse

    cands = read_singlepulse(path)
    return render_bowtie_svg(
        cands["time_s"], cands["dm"], cands["snr"],
        widths=cands["width"],
        title=f"DM-time bowtie — {path.split('/')[-1]}",
        **kw,
    )


def bowtie_from_db(
    db_path: str,
    job_id: str | None = None,
    tenant: str | None = None,
    **kw,
) -> str:
    """Bowtie SVG over a campaign database's single-pulse candidates
    (optionally one job's, or one tenant's observations), with
    per-observation time offsets from tstart so a multi-observation
    campaign lays out on one axis."""
    from ..campaign.db import CandidateDB

    with CandidateDB(db_path) as db:
        rows = db.all_candidates(kind="single_pulse")
    if job_id is not None:
        rows = [r for r in rows if r.get("job_id") == job_id]
    if tenant is not None:
        rows = [r for r in rows if (r.get("tenant") or "") == tenant]
    if rows:
        t0_mjd = min(float(r.get("obs_tstart") or 0.0) for r in rows)
    times, dms, snrs, widths = [], [], [], []
    for r in rows:
        day_off = (float(r.get("obs_tstart") or 0.0) - t0_mjd) * 86400.0
        times.append(day_off + float(r.get("time_s") or 0.0))
        dms.append(float(r.get("dm") or 0.0))
        snrs.append(float(r.get("snr") or 0.0))
        widths.append(int(r.get("width") or 0))
    title = (
        "DM-time bowtie — campaign DB"
        + (f" [{job_id}]" if job_id else "")
        + (f" [tenant {tenant}]" if tenant else "")
    )
    return render_bowtie_svg(
        times, dms, snrs, widths=widths, title=title, **kw
    )


def bowtie_main(argv=None) -> int:
    """``peasoup-bowtie`` — render the DM-time bowtie diagnostic from
    a campaign DB (candidates.sqlite) or a .singlepulse table."""
    import argparse

    p = argparse.ArgumentParser(prog="peasoup-bowtie")
    p.add_argument(
        "source",
        help="candidates.sqlite (campaign DB) or a .singlepulse table",
    )
    p.add_argument("-o", "--outfile", default="bowtie.svg")
    p.add_argument("--job", default=None,
                   help="restrict a DB source to one job id")
    p.add_argument("--min-snr", type=float, default=0.0)
    args = p.parse_args(argv)
    if args.source.endswith(".singlepulse"):
        svg = bowtie_from_singlepulse(args.source, min_snr=args.min_snr)
    else:
        svg = bowtie_from_db(
            args.source, job_id=args.job, min_snr=args.min_snr
        )
    with open(args.outfile, "w") as f:
        f.write(svg)
    print(args.outfile)
    return 0


def main(argv=None) -> int:
    import argparse

    p = argparse.ArgumentParser(prog="peasoup-plot-cand")
    p.add_argument("overview")
    p.add_argument("candfile")
    p.add_argument("idx", type=int)
    p.add_argument("-o", "--outfile", default="cand.png")
    args = p.parse_args(argv)
    from .parsers import CandidateFileParser, OverviewFile

    ov = OverviewFile(args.overview)
    with CandidateFileParser(args.candfile) as cp:
        CandidatePlotter(ov, cp).plot(args.idx, args.outfile)
    print(args.outfile)
    return 0


if __name__ == "__main__":
    import sys

    sys.exit(main())
