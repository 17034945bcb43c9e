"""Intersession-alignment QC: mutual information across scanning sessions.

The port's counterpart of ``examples/intersession_alignment_qc.py``, a
rebuild of the reference's notebooks/intersession_alignment.ipynb: for each
subject, compare every session's anatomical/functional volume against the
session-1 reference with mutual information (the notebook shells out to
nipype's Similarity node; here io.atlas.mutual_information is the in-framework
primitive), both RAW and after coregistration, and plot the per-subject MI
trajectory over sessions — the figure class the notebook saves as
mi_t1_t1.png.

With --data-dir the volumes are read from the BIDS-ish session layout the
notebook globs (<subject>/<session>/anat/*.nii*); without it, a synthetic
multi-session study is generated (per-session drift + noise, plus the
"coregistered" variant with the drift removed) so the QC pipeline runs
end-to-end on any box.

It runs on the host alone (numpy; nibabel for real volumes, matplotlib for
the figure), as its JAX-package counterpart does.

Run:  python -m multimodal_decoding_tpu_torch.examples.intersession_alignment_qc --out-dir qc
"""

import argparse
import os

import numpy as np


def synthetic_sessions(n_subjects=3, n_sessions=5, shape=(24, 28, 22), seed=0):
    """{subject: {session: {"raw": vol, "coregistered": vol}}} with a
    session-dependent spatial drift that coregistration removes."""
    rng = np.random.RandomState(seed)
    # shared smooth anatomy + per-subject detail
    zz, yy, xx = np.meshgrid(*[np.linspace(-1, 1, s) for s in shape], indexing="ij")
    base = np.exp(-(xx ** 2 + yy ** 2 + zz ** 2) * 3)
    data = {}
    for s in range(n_subjects):
        subject = f"sub-{s + 1:02d}"
        detail = rng.rand(*shape)
        anat = base + 0.5 * detail
        sessions = {}
        for k in range(n_sessions):
            session = f"ses-{k + 1:02d}"
            shift = k  # voxels of drift vs session 1
            drifted = np.roll(anat, shift, axis=2)
            noise = 0.05 * (1 + 0.3 * k)
            sessions[session] = {
                "raw": drifted + noise * rng.randn(*shape),
                "coregistered": anat + noise * rng.randn(*shape),
            }
        data[subject] = sessions
    return data


def qc_table(data, bins=64):
    """MI of every session vs the subject's first session, raw + coregistered
    (the notebook's two sweeps in one long-form table)."""
    from multimodal_decoding_tpu_torch.io.atlas import (
        mutual_information,
        normalized_mutual_information,
    )

    rows = []
    for subject, sessions in data.items():
        names = sorted(sessions)
        ref = sessions[names[0]]
        for session in names[1:]:
            for variant in ("raw", "coregistered"):
                rows.append({
                    "subject": subject,
                    "session": session.split("-")[1],
                    "variant": variant,
                    "mutual_information": mutual_information(
                        ref[variant], sessions[session][variant], bins=bins
                    ),
                    "normalized_mi": normalized_mutual_information(
                        ref[variant], sessions[session][variant], bins=bins
                    ),
                })
    return rows


def load_bids_sessions(data_dir, subjects=None):
    """Read <subject>/<session>/anat volumes from a BIDS-ish tree (the
    notebook's glob contract); 'coregistered' falls back to raw when no
    coregistered derivative exists."""
    import glob

    import nibabel as nib

    data = {}
    for subj_dir in sorted(glob.glob(os.path.join(data_dir, "sub-*"))):
        subject = os.path.basename(subj_dir)
        if subjects and subject not in subjects:
            continue
        sessions = {}
        for ses_dir in sorted(glob.glob(os.path.join(subj_dir, "ses-*"))):
            vols = sorted(
                glob.glob(os.path.join(ses_dir, "anat", "*.nii"))
                + glob.glob(os.path.join(ses_dir, "anat", "*.nii.gz"))
            )
            if not vols:
                continue
            raw = np.asanyarray(nib.load(vols[0]).dataobj)
            coreg = sorted(glob.glob(os.path.join(ses_dir, "anat", "r*.nii")))
            sessions[os.path.basename(ses_dir)] = {
                "raw": raw,
                "coregistered": (
                    np.asanyarray(nib.load(coreg[0]).dataobj) if coreg else raw
                ),
            }
        if sessions:
            data[subject] = sessions
    return data


def plot_qc(rows, out_path):
    """Per-subject MI-over-session lines, raw vs coregistered panels (the
    notebook's sns.lineplot figure)."""
    import matplotlib

    matplotlib.use("Agg", force=False)
    import matplotlib.pyplot as plt

    variants = ("raw", "coregistered")
    fig, axes = plt.subplots(1, len(variants), figsize=(10, 4), sharey=True)
    for ax, variant in zip(axes, variants):
        sel = [r for r in rows if r["variant"] == variant]
        for subject in sorted({r["subject"] for r in sel}):
            pts = [(r["session"], r["mutual_information"])
                   for r in sel if r["subject"] == subject]
            ax.plot([p[0] for p in pts], [p[1] for p in pts],
                    marker="o", label=subject)
        ax.set_title(variant)
        ax.set_xlabel("session")
    axes[0].set_ylabel("mutual information vs session 1")
    axes[0].legend(fontsize=8)
    fig.tight_layout()
    fig.savefig(out_path, dpi=150)
    plt.close(fig)
    return out_path


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--data-dir", type=str, default=None,
                    help="BIDS-ish tree (sub-*/ses-*/anat); synthetic if unset")
    ap.add_argument("--subjects", type=str, nargs="+", default=None)
    ap.add_argument("--out-dir", type=str, default=".")
    ap.add_argument("--bins", type=int, default=64)
    args = ap.parse_args(argv)

    data = (load_bids_sessions(args.data_dir, args.subjects) if args.data_dir
            else synthetic_sessions())
    rows = qc_table(data, bins=args.bins)

    os.makedirs(args.out_dir, exist_ok=True)
    print(f"{'subject':8s} {'session':8s} {'variant':14s} {'MI':>7s} {'NMI':>7s}")
    for r in rows:
        print(f"{r['subject']:8s} {r['session']:8s} {r['variant']:14s} "
              f"{r['mutual_information']:7.3f} {r['normalized_mi']:7.3f}")

    # QC verdict: coregistration should recover alignment lost to drift
    for subject in sorted(data):
        raw = [r["mutual_information"] for r in rows
               if r["subject"] == subject and r["variant"] == "raw"]
        coreg = [r["mutual_information"] for r in rows
                 if r["subject"] == subject and r["variant"] == "coregistered"]
        flag = "" if np.mean(coreg) >= np.mean(raw) else "  <-- CHECK ALIGNMENT"
        print(f"{subject}: mean MI raw {np.mean(raw):.3f} -> "
              f"coregistered {np.mean(coreg):.3f}{flag}")

    path = plot_qc(rows, os.path.join(args.out_dir, "mi_t1_t1.png"))
    print(f"wrote {path}")


if __name__ == "__main__":
    main()
