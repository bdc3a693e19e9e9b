"""mvntool — read / overwrite / insert parameters in an MVN checkpoint.

Port of fabber_core_tpu/tools/mvntool.py over the port's io.nifti and
io.mvn; capability parity with the reference mvn_tool/mvntool.cc:
extract a parameter's value/variance/covariance to an image, overwrite a
parameter's mean/variance (scalar or per-voxel image), or insert a new
parameter at a given position, with name-based addressing through
--param-list / --new-param-list files.

Usage: python -m fabber_core_tpu_torch.tools.mvntool --input=... --param=...
"""

import sys

import numpy as np

from ..exceptions import FabberError, MandatoryOptionMissing
from ..io import mvn as mvn_io
from ..io import nifti
from ..options import RunOptions


def _load_mvn(options):
    """Load the input MVN NIFTI. Voxels are taken from --mask if given,
    otherwise auto-detected from the trailing-1 marker row."""
    img = nifti.load(options.get_string("input"))
    vols = img.data.reshape(-1, img.nt, order="F")  # [NXYZ, rows]
    if options.have("mask"):
        mask_img = nifti.load(options.get_string("mask"))
        mask = mask_img.data.flatten(order="F") > 1e-16
    else:
        mask = vols[:, -1] == 1.0
    if not mask.any():
        raise FabberError("No valid MVN voxels found (no trailing-1 rows)")
    means, cov = mvn_io.unpack(vols[mask].T.astype(np.float64))
    return img, mask, means, cov


def _save_like(img, mask, values, filename, intent=nifti.NIFTI_INTENT_NONE):
    values = np.asarray(values)
    if values.ndim == 1:
        values = values[:, None]
    flat = np.zeros((int(np.prod(img.shape[:3])), values.shape[1]), np.float32)
    flat[mask] = values
    vol = flat.reshape(img.shape[:3] + (values.shape[1],), order="F")
    if values.shape[1] == 1:
        vol = vol[..., 0]
    nifti.save(nifti.NiftiImage(vol, pixdims=img.pixdims, intent=intent,
                                affine_bytes=img.affine_bytes), filename)


def _read_names(path):
    with open(path) as f:
        return [line.rstrip("\n") for line in f if line.strip()]


def _resolve_param(options):
    """Returns (param 1-based, insert_flag_override, names_to_write)."""
    plist = options.get_string("param-list", "")
    if not plist:
        return int(options.get_string("param")), None, None
    names = _read_names(plist)
    pname = options.get_string("param")
    nplist = options.get_string("new-param-list", "")
    if not nplist:
        if pname not in names:
            raise FabberError("Cannot find specified parameter name in list")
        return names.index(pname) + 1, None, None

    # inserting relative to a new parameter list
    new_names = _read_names(nplist)
    if pname in names:
        raise FabberError(
            "Parameter name found in parameter list for this MVN, cannot "
            "insert an identical parameter")
    if pname not in new_names:
        raise FabberError(
            "Cannot find specified parameter name in new parameter name list")
    newpos = new_names.index(pname)
    if newpos == 0:
        param = 1
    else:
        prev = new_names[newpos - 1]
        if prev not in names:
            raise FabberError(
                "Cannot complete this operation since the new list contains "
                "other parameters not present in the old list")
        param = names.index(prev) + 2
    out_names = names[:param - 1] + [pname] + names[param - 1:]
    return param, True, out_names


def main(argv=None):
    argv = sys.argv[1:] if argv is None else argv
    options = RunOptions()
    try:
        for arg in argv:
            options.parse_cli([arg])
        if not argv or options.get_bool("help"):
            print(__doc__)
            return 0
        return run(options)
    except FabberError as e:
        sys.stderr.write(f"{e}\n")
        return 1


def run(options):
    infile = options.get_string("input")
    outfile = options.get_string("output", infile)
    verbose = options.get_bool("v")

    param, ins_override, out_names = _resolve_param(options)
    ins = options.get_bool("new") or bool(ins_override)
    write = options.get_bool("write")
    if ins and write:
        raise FabberError("Cannot insert and write at same time - choose "
                          "either --new or --write")

    img, mask, means, cov = _load_mvn(options)
    nv, size = means.shape

    if ins or write:
        # values to write: scalar or per-voxel image
        valim = options.get_string("valim", "")
        varim = options.get_string("varim", "")
        val = np.full(nv, options.get_float("val", -1e-6))
        var = np.full(nv, options.get_float("var", -1e-6))
        if valim:
            val = nifti.load(valim).data.flatten(order="F")[mask]
        if varim:
            var = nifti.load(varim).data.flatten(order="F")[mask]

        if ins:
            if param > size + 1:
                raise FabberError("Cannot insert parameter here, not enough "
                                  "parameters in existing MVN")
            new_means = np.insert(means, param - 1, 0.0, axis=1)
            new_cov = np.zeros((nv, size + 1, size + 1))
            keep = [i for i in range(size + 1) if i != param - 1]
            new_cov[np.ix_(range(nv), keep, keep)] = cov
            means, cov, size = new_means, new_cov, size + 1
        else:
            if param > size:
                raise FabberError("Cannot edit this parameter, not enough "
                                  "parameters in existing MVN")
        means[:, param - 1] = val
        # zero the row/col then set the variance, as insert semantics
        cov[:, param - 1, param - 1] = var

        packed = mvn_io.pack(means, cov).T  # [V, rows]
        _save_like(img, mask, packed.astype(np.float32), outfile,
                   intent=nifti.NIFTI_INTENT_SYMMATRIX)
        if out_names is not None:
            out_param_file = options.get_string("out-param-file", "")
            if out_param_file:
                with open(out_param_file, "w") as f:
                    f.writelines(n + "\n" for n in out_names)
        if verbose:
            print(f"Wrote {outfile}")
    else:
        if outfile == infile:
            raise MandatoryOptionMissing("output")
        bval = options.get_bool("val")
        bvar = options.get_bool("var")
        cparam = options.get_int("cvar", 0)
        chosen = sum([bval, bvar, cparam > 0])
        if chosen != 1:
            raise FabberError(
                "Please select exactly one of --val, --var or --cvar=<n>")
        if bval:
            image = means[:, param - 1]
        elif bvar:
            image = cov[:, param - 1, param - 1]
        else:
            image = cov[:, param - 1, cparam - 1]
        _save_like(img, mask, image.astype(np.float32), outfile)
        if verbose:
            print(f"Wrote {outfile}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
