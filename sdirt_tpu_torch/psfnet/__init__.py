from .arch import build_psfnet, load_torch_psfnet  # noqa: F401
from .surrogate import PSFNetLens, pred_psf  # noqa: F401
from .thinlens import ThinLens  # noqa: F401
from .train import fit_psfnet  # noqa: F401
