"""Standalone worker entry, invoked by file path (not ``-m``) so the
package import happens exactly once inside the child."""

if __name__ == "__main__":
    import os
    import sys

    sys.path.insert(
        0, os.path.dirname(os.path.dirname(os.path.dirname(
            os.path.abspath(__file__)))))
    from ray_tpu_torch._private.worker_process import _standalone_main

    _standalone_main()
