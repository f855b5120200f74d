# The effect-handler core of the PyTorch port: primitives and handlers form
# the dist-free effect stack and initialize first, then the distribution
# library.  Inference lives in `repro_torch.core.infer`.
from . import handlers, primitives
from . import dist
from . import reparam
from .primitives import deterministic, param, plate, sample, subsample

__all__ = ["dist", "handlers", "primitives", "reparam", "sample", "param",
           "deterministic", "plate", "subsample"]
