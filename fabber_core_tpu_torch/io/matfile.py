"""Matrix file I/O: FSL VEST format and plain ASCII.

Capability parity with fabber::read_matrix_file (tools.cc:27-40): try
VEST first, fall back to whitespace-separated ASCII with '#'/'%'
comments.
"""

import numpy as np


def read_vest(filename):
    nwaves = npoints = None
    rows = []
    in_matrix = False
    with open(filename) as f:
        for line in f:
            s = line.strip()
            if not s:
                continue
            if s.startswith("/"):
                parts = s.split()
                key = parts[0].lower()
                if key == "/numwaves":
                    nwaves = int(parts[1])
                elif key == "/numpoints" or key == "/numcontrasts":
                    npoints = int(parts[1])
                elif key == "/matrix":
                    in_matrix = True
                continue
            if in_matrix:
                rows.append([float(x) for x in s.split()])
    if not in_matrix:
        raise ValueError(f"{filename}: not a VEST file (no /Matrix)")
    mat = np.array(rows, dtype=np.float64)
    if npoints is not None and nwaves is not None:
        if mat.shape != (npoints, nwaves):
            raise ValueError(
                f"{filename}: VEST matrix is {mat.shape}, header says {(npoints, nwaves)}")
    return mat


def read_ascii_matrix(filename):
    rows = []
    with open(filename) as f:
        for line in f:
            s = line.strip()
            if not s or s[0] in "#%/":
                continue
            rows.append([float(x) for x in s.split()])
    if not rows:
        raise ValueError(f"{filename}: no numeric rows found")
    return np.array(rows, dtype=np.float64)


def read_matrix_file(filename):
    """VEST-then-ASCII fallback."""
    try:
        return read_vest(filename)
    except Exception:
        return read_ascii_matrix(filename)


def write_vest(mat, filename):
    mat = np.atleast_2d(np.asarray(mat))
    with open(filename, "w") as f:
        f.write(f"/NumWaves\t{mat.shape[1]}\n")
        f.write(f"/NumPoints\t{mat.shape[0]}\n")
        f.write("/Matrix\n")
        for row in mat:
            f.write("\t".join(f"{x:.9e}" for x in row) + "\n")
