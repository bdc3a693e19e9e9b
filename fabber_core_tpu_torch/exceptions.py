"""Exception hierarchy.

Mirrors the error taxonomy of the reference (rundata.h:676-758) so users
switching over see equivalent failure modes, without copying its design.
"""


class FabberError(RuntimeError):
    """Base class for all framework errors."""


class InvalidOptionValue(FabberError):
    def __init__(self, key, value, reason=""):
        self.key, self.value, self.reason = key, str(value), reason
        super().__init__(f"Invalid value '{value}' for option '{key}': {reason}")


class MandatoryOptionMissing(FabberError):
    def __init__(self, key):
        self.key = key
        super().__init__(f"Mandatory option '{key}' was not specified")


class DataNotFound(FabberError):
    def __init__(self, key, reason=""):
        self.key = key
        super().__init__(f"Voxel data '{key}' not found: {reason}")


class FabberInternalError(FabberError):
    """Numerical or logic errors inside the engine (bad voxels etc.)."""


class BadVoxelError(FabberInternalError):
    """Numerical failure localized to specific voxels.

    The engine raises this when voxels fail and --allow-bad-voxels is not
    set (reference: inference.cc:88-109).
    """

    def __init__(self, voxel_indices, msg=""):
        self.voxel_indices = list(voxel_indices)
        n = len(self.voxel_indices)
        head = ", ".join(str(v) for v in self.voxel_indices[:8])
        super().__init__(
            f"Numerical error in {n} voxel(s) [{head}{'...' if n > 8 else ''}] {msg} "
            "(use allow-bad-voxels to continue past them)")
