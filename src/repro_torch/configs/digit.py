"""The paper's handwritten-digit DNN (§2.1): 784-1022-1022-1022-10, sigmoid
hidden units, 3-bit hidden weights / 8-bit output weights, 8-bit signals."""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="digit", family="mlp",
    num_layers=3, d_model=1022, vocab_size=10,   # d_model = hidden width
    d_ff=784, mlp_act="sigmoid",                 # d_ff reused as input dim
)

INPUT_DIM = 784
HIDDEN = (1022, 1022, 1022)
NUM_CLASSES = 10
