from .model import NewCRFDepth
from .uper import UPerHead
