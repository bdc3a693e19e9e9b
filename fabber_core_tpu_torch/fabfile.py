"""`.fab` option-file round trip.

Port of fabber_core_tpu/fabfile.py (plain Python, copied so the port
imports nothing of the JAX package): the reference binding's run-file
handling (py/fabber.py), a dict-like view of a `key=value` option file
that preserves comments, blank lines and line order on save, so
hand-maintained run files survive programmatic edits.

Design: ONE ordered list of typed entries is the whole document model.
Every line of the file — comment, blank, or option — is an `_Entry`
row in order; the mapping protocol is a view over the option rows
(there is no separate key->value store to keep in sync). Appends go to
the end, deletes drop the row, and `dump` is a single pass over the
list.
"""

import os


_COMMENT, _BLANK, _OPTION = "comment", "blank", "option"


class _Entry:
    __slots__ = ("kind", "key", "value")

    def __init__(self, kind, key=None, value=""):
        self.kind = kind
        self.key = key
        self.value = value

    def render(self, mask=None):
        if self.kind == _BLANK:
            return ""
        if self.kind == _COMMENT:
            return self.value
        if self.key == "mask" and mask is not None:
            return f"mask={mask}"
        if self.value == "":
            return self.key  # boolean flag: bare key
        return f"{self.key}={self.value}"


class FabRunFile:
    """Options for a run, loadable from / savable to a .fab file.

    Mapping-style access reads and writes option entries in place;
    iteration yields option keys in file order.
    """

    def __init__(self, filename=None):
        self._entries = []
        self.filepath = None
        if filename:
            self.load(filename)

    def _find(self, key):
        for e in self._entries:
            if e.kind == _OPTION and e.key == key:
                return e
        return None

    # -- mapping protocol ------------------------------------------------
    def __getitem__(self, key):
        e = self._find(key.strip())
        if e is None:
            raise KeyError(key)
        return e.value

    def __setitem__(self, key, value):
        key = key.strip()
        if not key:
            return
        e = self._find(key)
        if e is None:
            self._entries.append(_Entry(_OPTION, key, str(value).strip()))
        else:
            e.value = str(value).strip()

    def __delitem__(self, key):
        key = key.strip()
        e = self._find(key)
        if e is not None:
            self._entries.remove(e)

    def __contains__(self, key):
        return self._find(key.strip()) is not None

    def __iter__(self):
        return (e.key for e in self._entries if e.kind == _OPTION)

    def __len__(self):
        return sum(1 for e in self._entries if e.kind == _OPTION)

    def keys(self):
        return list(self)

    def items(self):
        return [(e.key, e.value) for e in self._entries
                if e.kind == _OPTION]

    def get(self, key, default=None):
        e = self._find(key.strip())
        return default if e is None else e.value

    def update(self, other):
        for k, v in (other.items() if hasattr(other, "items") else other):
            self[k] = v

    def __eq__(self, other):
        if hasattr(other, "items"):
            return dict(self.items()) == dict(other.items())
        return NotImplemented

    # -- comments --------------------------------------------------------
    def add_comment(self, comment, option=None):
        """Insert a comment line, before `option`'s line when given
        (at the top otherwise)."""
        entry = _Entry(_COMMENT, value=f"# {comment}")
        if option is None:
            self._entries.insert(0, entry)
            return
        e = self._find(option.strip())
        if e is None:
            raise ValueError(f"No such option: {option}")
        self._entries.insert(self._entries.index(e), entry)

    # -- file I/O --------------------------------------------------------
    def load(self, filename):
        self.filepath = os.path.abspath(filename)
        with open(filename) as f:
            for raw in f:
                line = raw.strip()
                if not line:
                    self._entries.append(_Entry(_BLANK))
                elif line.startswith("#"):
                    self._entries.append(_Entry(_COMMENT, value=line))
                else:
                    key, _, value = line.partition("=")
                    self._entries.append(
                        _Entry(_OPTION, key.strip(), value.strip()))
        return self

    def save(self, filename=None, mask=None):
        filename = filename or self.filepath
        if not filename:
            raise RuntimeError("No file specified for save")
        with open(filename, "w") as f:
            self.dump(f, mask=mask)
        self.filepath = os.path.abspath(filename)

    def dump(self, stream, mask=None):
        for e in self._entries:
            stream.write(e.render(mask=mask))
            stream.write("\n")
