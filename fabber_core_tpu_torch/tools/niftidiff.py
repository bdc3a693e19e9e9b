"""niftidiff — compare two NIFTI volumes within a tolerance.

Port of fabber_core_tpu/tools/niftidiff.py over the port's io.nifti;
capability parity with the reference test/niftidiff.cc (eps 0.01
default, optional mask, ignore-zero mode) plus the recursive directory
mode of test/outdiff.py (eps 1e-6 default).

Usage:
  python -m fabber_core_tpu_torch.tools.niftidiff FILE1 FILE2 [--eps=E]
         [--mask=MASK] [--ignore-zero]
  python -m fabber_core_tpu_torch.tools.niftidiff DIR1 DIR2 [--eps=E]
Exit code 0 if identical within tolerance, 1 otherwise.
"""

import os
import sys

import numpy as np

from ..io import nifti


def diff_files(f1, f2, eps=0.01, mask=None, ignore_zero=False):
    """Returns (ok, message)."""
    a = nifti.load(f1).data.astype(np.float64)
    b = nifti.load(f2).data.astype(np.float64)
    if a.shape != b.shape:
        return False, f"shape mismatch: {a.shape} vs {b.shape}"
    sel = np.ones(a.shape, bool)
    if mask is not None:
        m = nifti.load(mask).data > 1e-16
        sel &= m.reshape(m.shape + (1,) * (a.ndim - m.ndim))
    if ignore_zero:
        sel &= (a != 0) & (b != 0)
    d = np.abs(a - b)[sel]
    if d.size == 0:
        return True, "no voxels compared"
    worst = float(d.max())
    if worst > eps:
        n = int((d > eps).sum())
        return False, f"{n} voxels differ by more than {eps} (max {worst:.6g})"
    return True, f"identical within {eps} (max diff {worst:.6g})"


def diff_dirs(d1, d2, eps=1e-6):
    """Recursive comparison of all NIFTI files present in both dirs."""
    ok = True
    msgs = []
    names1 = {f for f in os.listdir(d1) if f.endswith((".nii", ".nii.gz"))}
    names2 = {f for f in os.listdir(d2) if f.endswith((".nii", ".nii.gz"))}
    for name in sorted(names1 & names2):
        fok, msg = diff_files(os.path.join(d1, name), os.path.join(d2, name),
                              eps=eps)
        msgs.append(f"{name}: {msg}")
        ok &= fok
    for name in sorted(names1 ^ names2):
        msgs.append(f"{name}: only in one directory")
        ok = False
    return ok, msgs


def main(argv=None):
    argv = sys.argv[1:] if argv is None else argv
    paths = [a for a in argv if not a.startswith("--")]
    opts = {a.split("=")[0].lstrip("-"): (a.split("=", 1)[1] if "=" in a else "")
            for a in argv if a.startswith("--")}
    if len(paths) != 2:
        print(__doc__)
        return 2

    if os.path.isdir(paths[0]):
        ok, msgs = diff_dirs(paths[0], paths[1],
                             eps=float(opts.get("eps", 1e-6)))
        for m in msgs:
            print(m)
    else:
        ok, msg = diff_files(paths[0], paths[1],
                             eps=float(opts.get("eps", 0.01)),
                             mask=opts.get("mask"),
                             ignore_zero="ignore-zero" in opts)
        print(msg)
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
