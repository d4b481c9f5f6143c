# Selection hot spots as hand-written Hopper kernels.  Each op lives in its
# own package (<name>/kernel.py launches the CUDA code in ../csrc, ops.py is
# the public wrapper, ref.py the plain torch version); the shared sentinel
# and dispatch rule are in common.py, the CUDA build in build.py, and the
# init/apply stage composition (embed -> retrieve -> score -> argmax) in
# stages.py.
