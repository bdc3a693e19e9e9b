"""Self-describing option system + run option store.

Equivalent capability to the reference's option machinery
(rundata.h:40-79 OptionSpec, rundata.cc:389-658 parsing/validation),
redesigned as a plain-Python registry:

  * OptionSpec tables per component (model / method / noise / global),
    aggregated for --help and API introspection.
  * RunOptions: string-valued store with typed getters, range
    validation, boolean presence semantics ("" == True), indexed option
    lists (ti1=.., ti2=..), option files, duplicate detection and
    unused-option warnings.
"""

from dataclasses import dataclass

from .exceptions import (FabberError, InvalidOptionValue,
                         MandatoryOptionMissing)

# Option value types, used only for introspection / help output
OPT_BOOL = "BOOL"
OPT_STR = "STR"
OPT_INT = "INT"
OPT_FLOAT = "FLOAT"
OPT_FILE = "FILE"
OPT_IMAGE = "IMAGE"
OPT_TIMESERIES = "TIMESERIES"
OPT_MVN = "MVN"
OPT_MATRIX = "MATRIX"


@dataclass(frozen=True)
class OptionSpec:
    name: str
    type: str = OPT_STR
    description: str = ""
    required: bool = False
    default: str = ""

    def as_tsv(self):
        """Introspection row: name, desc, type, optional, default.

        Same column layout as the C API introspection TSV
        (fabber_capi.h:155-170 / py/fabber.py:555).
        """
        return "\t".join(
            [self.name, self.description, self.type,
             "0" if self.required else "1", self.default])


GLOBAL_OPTIONS = [
    OptionSpec("help", OPT_BOOL, "Print usage information"),
    OptionSpec("listmethods", OPT_BOOL, "List all known inference methods"),
    OptionSpec("listmodels", OPT_BOOL, "List all known forward models"),
    OptionSpec("listparams", OPT_BOOL, "List model parameters"),
    OptionSpec("descparams", OPT_BOOL, "Describe model parameters"),
    OptionSpec("listoutputs", OPT_BOOL, "List additional model outputs"),
    OptionSpec("evaluate", OPT_STR, "Evaluate model forward pass; set to output name or blank"),
    OptionSpec("evaluate-params", OPT_MATRIX, "Parameter values for evaluation"),
    OptionSpec("evaluate-nt", OPT_INT, "Number of time points for evaluation"),
    OptionSpec("evaluate-data", OPT_MATRIX,
               "Timeseries data passed to the model for evaluation"),
    OptionSpec("simple-output", OPT_BOOL, "Progress as percentage lines only"),
    OptionSpec("output", OPT_STR, "Directory for output files (including logfile)", True),
    OptionSpec("overwrite", OPT_BOOL, "Overwrite existing output; otherwise append '+'"),
    OptionSpec("link-to-latest", OPT_BOOL, "Create link to most recent output dir"),
    OptionSpec("method", OPT_STR, "Inference method", True),
    OptionSpec("model", OPT_STR, "Forward model", True),
    OptionSpec("loadmodels", OPT_FILE, "Load models dynamically from a python module/file"),
    OptionSpec("data", OPT_TIMESERIES, "Single input data file", True),
    OptionSpec("data<n>", OPT_TIMESERIES, "Multiple data files for n=1,2,3..."),
    OptionSpec("data-order", OPT_STR, "concatenate or interleave", default="interleave"),
    OptionSpec("mask", OPT_IMAGE, "Mask file; inference only where mask > 0"),
    OptionSpec("mt<n>", OPT_INT, "Masked time points, indexed from 1"),
    OptionSpec("suppdata", OPT_TIMESERIES, "Supplemental timeseries data"),
    OptionSpec("dump-param-names", OPT_BOOL, "Write paramnames.txt"),
    OptionSpec("save-model-fit", OPT_BOOL, "Output model prediction as 4d volume"),
    OptionSpec("save-residuals", OPT_BOOL, "Output data - model prediction"),
    OptionSpec("save-model-extras", OPT_BOOL, "Output model-specific timeseries"),
    OptionSpec("save-mvn", OPT_BOOL, "Output final MVN distributions"),
    OptionSpec("save-mean", OPT_BOOL, "Output parameter means"),
    OptionSpec("save-std", OPT_BOOL, "Output parameter standard deviations"),
    OptionSpec("save-var", OPT_BOOL, "Output parameter variances"),
    OptionSpec("save-zstat", OPT_BOOL, "Output parameter z-statistics"),
    OptionSpec("save-noise-mean", OPT_BOOL, "Output noise precision means"),
    OptionSpec("save-noise-std", OPT_BOOL, "Output noise standard deviations"),
    OptionSpec("save-free-energy", OPT_BOOL, "Output free energy"),
    OptionSpec("optfile", OPT_FILE,
               "File of additional options (legacy whitespace-separated "
               "'--key=value' format, like -@)"),
    OptionSpec("debug", OPT_BOOL, "Verbose numerical debug output"),
    OptionSpec("dtype", OPT_STR,
               "Precision: double|single|bf16 (bf16 = bfloat16 data "
               "storage with float32 compute)", default="double"),
    OptionSpec("gzip-log", OPT_BOOL, "Compress the logfile on normal exit"),
    OptionSpec("profile-dir", OPT_STR, "Write a torch.profiler trace here"),
    OptionSpec("no-compat-output", OPT_BOOL,
               "Disable the backwards-compatible default output set"),
    OptionSpec("shard-voxels", OPT_BOOL,
               "Shard the voxel axis over all available devices"),
    OptionSpec("distributed", OPT_BOOL,
               "Multi-host run: initialize jax.distributed, shard the "
               "voxel axis over the global device mesh with "
               "process-local data feeding"),
    OptionSpec("coordinator-address", OPT_STR,
               "host:port of process 0 (distributed mode; TPU pods "
               "auto-detect)"),
    OptionSpec("num-processes", OPT_INT,
               "Total process count (distributed mode; auto-detected "
               "on TPU pods)"),
    OptionSpec("process-id", OPT_INT,
               "This process's index (distributed mode; auto-detected "
               "on TPU pods)"),
]


class RunOptions:
    """String-valued option store with typed access and usage tracking."""

    def __init__(self, options=None):
        self._opts = {}
        self._used = set()
        if options:
            for k, v in options.items():
                self.set(k, v)

    # -- mutation ----------------------------------------------------------
    def set(self, key, value):
        key = str(key).strip()
        if key == "":
            return
        if isinstance(value, bool):
            # Boolean options follow presence semantics: True == present
            # with empty value, False == absent.
            if value:
                self._opts[key] = ""
            else:
                self._opts.pop(key, None)
            return
        self._opts[key] = str(value).strip()

    def unset(self, key):
        self._opts.pop(key, None)

    def update(self, other):
        for k, v in dict(other).items():
            self.set(k, v)

    # -- parsing -----------------------------------------------------------
    def parse_cli(self, argv):
        """Parse --key=value / --key argument style (rundata.cc:389-453)."""
        for arg in argv:
            if arg.startswith("--"):
                arg = arg[2:]
            elif arg.startswith("-@"):
                raise InvalidOptionValue("-@", arg, "Old-style option files: use -f/--optfile")
            elif arg.startswith("-f"):
                continue  # handled by caller alongside its argument
            self._add_key_equals_value(arg)
        return self

    def parse_option_file(self, filename):
        """key=value per line; '#' comments, including trailing ones
        after the value (rundata.cc:324-346, trim_comments=true)."""
        with open(filename) as f:
            for line in f:
                line = line.strip()
                if not line or line.startswith("#"):
                    continue
                if "=" in line:
                    # the reference trims the value at the first '#'
                    line = line.split("#", 1)[0].rstrip()
                self._add_key_equals_value(line)
        return self

    def parse_old_style_option_file(self, filename):
        """Legacy -@/--optfile format (rundata.cc:348-387):
        whitespace-separated '--key[=value]' tokens, '#' discards the
        rest of its line, bare words are an error, nested -@ rejected.
        """
        try:
            with open(filename) as f:
                text = f.read()
        except OSError:
            raise FabberError(
                f"Couldn't read input file: -@ {filename}")
        for line in text.splitlines():
            for tok in line.split():
                if tok.startswith("#"):
                    break  # comment: discard the rest of the line
                if tok.startswith("--"):
                    self._add_key_equals_value(tok[2:])
                elif tok.startswith("-@"):
                    raise FabberError(
                        "Can only use -@ on the command line")
                else:
                    raise FabberError(
                        f"Invalid data '{tok}' found in file "
                        f"'{filename}'")
        return self

    def _add_key_equals_value(self, kv):
        if "=" in kv:
            key, value = kv.split("=", 1)
        else:
            key, value = kv, ""
        key, value = key.strip(), value.strip().strip("'\"")
        if key in self._opts:
            raise InvalidOptionValue(key, value, "Duplicated option")
        self._opts[key] = value

    # -- typed getters -----------------------------------------------------
    def have(self, key):
        return key in self._opts

    def get_string(self, key, default=None):
        if key not in self._opts:
            if default is None:
                raise MandatoryOptionMissing(key)
            return default
        self._used.add(key)
        return self._opts[key]

    def get_bool(self, key):
        if key not in self._opts:
            return False
        self._used.add(key)
        if self._opts[key] != "":
            raise InvalidOptionValue(key, self._opts[key],
                                     "Boolean options must not have a value")
        return True

    def get_int(self, key, default=None, minval=None, maxval=None):
        s = self.get_string(key, None if default is None else str(default))
        try:
            val = int(s)
        except ValueError:
            raise InvalidOptionValue(key, s, "Must be an integer")
        self._check_range(key, val, minval, maxval)
        return val

    def get_float(self, key, default=None, minval=None, maxval=None):
        s = self.get_string(key, None if default is None else repr(float(default)))
        try:
            val = float(s)
        except ValueError:
            raise InvalidOptionValue(key, s, "Must be a number")
        self._check_range(key, val, minval, maxval)
        return val

    def _check_range(self, key, val, minval, maxval):
        if minval is not None and val < minval:
            raise InvalidOptionValue(key, val, f"Must be >= {minval}")
        if maxval is not None and val > maxval:
            raise InvalidOptionValue(key, val, f"Must be <= {maxval}")

    def get_int_list(self, key, min_index=1):
        """Indexed options key1=..,key2=.. (rundata.cc:557-574)."""
        out = []
        i = min_index
        while self.have(f"{key}{i}"):
            out.append(self.get_int(f"{key}{i}"))
            i += 1
        return out

    def get_string_list(self, key, min_index=1):
        out = []
        i = min_index
        while self.have(f"{key}{i}"):
            out.append(self.get_string(f"{key}{i}"))
            i += 1
        return out

    # -- bookkeeping -------------------------------------------------------
    def mark_used(self, key):
        self._used.add(key)

    def unused(self):
        return sorted(k for k in self._opts if k not in self._used)

    def items(self):
        return self._opts.items()

    def keys(self):
        return self._opts.keys()

    def __contains__(self, key):
        return key in self._opts

    def __len__(self):
        return len(self._opts)

    def copy(self):
        c = RunOptions()
        c._opts = dict(self._opts)
        return c

    def __repr__(self):
        return f"RunOptions({self._opts!r})"
