"""KF-parameter fitting CLI (port of ``playground3d_tpu/apps/fit_filter.py``;
reference fit_filter_3D.py): learn Q/R/class
sizes/velocity priors from GT tracklets (synthetic scene or a tracking CSV)
and save them as an npz loadable by ``params_from_arrays``.

Usage:
    python -m playground3d_tpu_torch.apps.fit_filter --out kf_params.npz \
        [--csv tracks.csv] [--noise-px 2.0]
"""

from __future__ import annotations

import argparse

import numpy as np


def main(argv=None) -> dict:
    """Fit and save the parameters; -> the fitted arrays (numpy, host)."""
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--csv", default=None, help="GT tracking CSV (else synthetic)")
    ap.add_argument("--out", default="kf_params.npz")
    ap.add_argument("--noise-px", type=float, default=2.0)
    ap.add_argument("--n-tracklets", type=int, default=60)
    args = ap.parse_args(argv)

    from playground3d_tpu_torch.train import fit_kf

    rng = np.random.default_rng(0)

    if args.csv:
        from playground3d_tpu_torch.evaluation.datareader import TimeIndexedTracks

        tracks = TimeIndexedTracks.from_csv(args.csv)
        tracklets = [tracks.states[oid] for oid in tracks.ids() if len(tracks.states[oid]) >= 9]
        sizes = np.concatenate([t[:, 2:5] for t in tracklets])
        from playground3d_tpu_torch.utils.constants import CLASS_IDS

        class_ids = np.concatenate(
            [
                np.full(len(tracks.states[oid]), CLASS_IDS.get(tracks.classes[oid], 5))
                for oid in tracks.ids()
                if len(tracks.states[oid]) >= 9
            ]
        )
        # measurement residuals: jitter GT as detection stand-ins
        gts = np.concatenate([t[:, :5] for t in tracklets])
        dets = gts + rng.normal(0, 0.5, gts.shape)
    else:
        from playground3d_tpu_torch.data.synthetic import SyntheticScene

        tracklets = []
        all_cls, all_sizes = [], []
        for k in range(args.n_tracklets):
            scene = SyntheticScene(n_objects=1, seed=k)
            rows = []
            for f in range(40):
                s, idx = scene.states_at(f / 30.0)
                if len(s):
                    rows.append(s[0] + np.concatenate([rng.normal(0, 0.05, 5), [0, 0]]))
            if len(rows) >= 9:
                tracklets.append(np.stack(rows))
                all_cls.append(scene.classes[0])
                all_sizes.append(tracklets[-1][0, 2:5])
        class_ids = np.asarray(all_cls)
        sizes = np.stack(all_sizes)
        gts = np.concatenate([t[:, :5] for t in tracklets])
        dets = gts + rng.normal(0, args.noise_px * 0.25, gts.shape)

    out = fit_kf.fit_all(tracklets, dets, gts, class_ids=class_ids, sizes=sizes)
    fit_kf.save_kf_params(args.out, out)
    print(f"fitted KF params from {len(tracklets)} tracklets -> {args.out}")
    print("Q diag:", np.round(np.diag(out["Q"]), 4))
    print("R diag:", np.round(np.diag(out["R"]), 4))
    print("mu_v:", round(float(out["mu_v"]), 2))
    return out


if __name__ == "__main__":
    main()
