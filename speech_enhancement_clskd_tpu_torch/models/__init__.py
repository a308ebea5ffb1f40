from .dccrn import DCCRN, DCCRNOutput, FeatureTaps, make_model
from .dccrnet import DCCRNet
