"""Models: the Llama-family decoder (its training, decode and speculative
paths) and the BatchNorm conv nets."""

from tensorflowonspark_tpu_torch.models.llama import (  # noqa: F401
    Llama,
    LlamaConfig,
    llama_param_shardings,
)
from tensorflowonspark_tpu_torch.models.speculative import (  # noqa: F401
    speculative_accept,
    speculative_generate,
)
