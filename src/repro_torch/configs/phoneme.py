"""The paper's TIMIT phoneme DNN (§2.1): 429-1022x4-61 (11 frames of MFCC),
sigmoid hidden units, 3-bit hidden weights / 8-bit output weights."""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="phoneme", family="mlp",
    num_layers=4, d_model=1022, vocab_size=61,
    d_ff=429, mlp_act="sigmoid",
)

INPUT_DIM = 429
HIDDEN = (1022, 1022, 1022, 1022)
NUM_CLASSES = 61
