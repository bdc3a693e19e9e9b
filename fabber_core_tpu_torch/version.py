"""Version info (reference: version.cc:5-21 stamps GIT_SHA1/GIT_DATE)."""

import subprocess

__version__ = "0.1.0"


def source_version() -> str:
    """Best-effort git describe, mirroring fabber_version()."""
    try:
        sha = subprocess.run(
            ["git", "rev-parse", "--short", "HEAD"],
            capture_output=True, text=True, timeout=5,
        ).stdout.strip()
        return f"{__version__}+git{sha}" if sha else __version__
    except Exception:
        return __version__
