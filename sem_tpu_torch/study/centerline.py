"""De Vahl Davis centerline anchors from a study ``.npz`` artifact, on the
port.

Counterpart of the JAX package's ``study/centerline.py``.  The de Vahl Davis
(1983) benchmark reports u_max on the vertical centerline x=0.5 and v_max on
the horizontal centerline y=0.5 (both scaled by Re·Pr).  The examples print
the *domain* maxima, which coincide with the centerline maxima at low Ra but
exceed them at high Ra (the u peak moves off-center), so high-Ra comparisons
need the true centerline values.  The evaluation is
:func:`sem_tpu_torch.study.summarize.centerline_anchors` (two point-evaluator
matmuls) on ``--device``.

Literature values (u_max·RePr / v_max·RePr):
  de Vahl Davis (1983), 41^2 FD + Richardson extrapolation:
    Ra=1e3: 3.649 / 3.697      Ra=1e4: 16.178 / 19.617
    Ra=1e5: 34.73 / 68.59      Ra=1e6: 64.63 / 219.36
  Le Quere (1991), pseudo-spectral "accurate solutions" (the canonical
  high-Ra values; the 1983 extrapolation carries ~0.3-0.5% error):
    Ra=1e6: 64.8344 / 220.559  Ra=1e7: 148.58 / 699.18

Usage: ``python -m sem_tpu_torch.study.centerline <dir>/<run>.npz P_ns Ne_ns
[--device cpu]`` (a field ``.npz`` of either package's study)
"""
import argparse

import numpy as np


def main(argv=None):
    """Print the two anchors; returns them."""
    from sem_tpu_torch.study.summarize import centerline_anchors
    from sem_tpu_torch.utils import cli_device

    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("path", help="field .npz of a study run")
    ap.add_argument("P", type=int, help="NS polynomial order")
    ap.add_argument("Ne", type=int, help="NS elements per direction")
    ap.add_argument("--device", default="cuda",
                    help="torch device (default cuda; cpu only when asked)")
    a = ap.parse_args(argv)
    device = cli_device(a.device)
    with np.load(a.path) as z:
        arrays = [z[k] for k in z.files]
    u_e, v_e = arrays[1], arrays[2]
    umax, vmax = centerline_anchors(u_e, v_e, a.P, a.Ne, device=device)
    print(f"u_max*RePr (x=0.5 centerline) = {umax:.4f}")
    print(f"v_max*RePr (y=0.5 centerline) = {vmax:.4f}")
    return umax, vmax


if __name__ == "__main__":
    main()
