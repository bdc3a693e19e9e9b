"""Build the port's C API and run its standalone C host:

    python -m fabber_core_tpu_torch.capi [DEVICE]

DEVICE (cuda, cpu) is passed to the host, which sets it as the option
`device`; with none the host sets no device and the run takes the card.
Exits with the host's code.
"""

import subprocess
import sys

from . import build, build_host, host_env


def main(argv=None):
    argv = sys.argv[1:] if argv is None else argv
    print(f"shim: {build()}", flush=True)
    host = build_host()
    print(f"host: {host}", flush=True)
    return subprocess.run([str(host), *argv], env=host_env()).returncode


if __name__ == "__main__":
    sys.exit(main())
