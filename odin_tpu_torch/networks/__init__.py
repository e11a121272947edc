"""Network layers and per-dataset architectures of the port."""
from odin_tpu_torch.networks.attention import (
    Attention,
    AttentionHeads,
    AttentionMechanism,
    GlobalAttention,
    LocalPredictiveAttention,
    MultiHeadAttention,
    SelfAttention,
    create_attention_heads,
)
from odin_tpu_torch.networks.base import (
    BatchNorm,
    CenterAt0,
    Conv,
    ConvTranspose,
    Dense,
    Flatten,
    GRUCell,
    Lambda,
    Reshape,
    SequentialNetwork,
    get_activation,
)
from odin_tpu_torch.networks.image_networks import (
    PackImageParams,
    dsprites_networks,
    get_networks,
    get_optimizer_info,
    halfmoons_networks,
    locatello_networks,
    shapes3d_networks,
    vq_dsprites_networks,
)
from odin_tpu_torch.networks.conditional_embedding import (
    DictionaryEmbedding,
    IdentityEmbedding,
    ProjectionEmbedding,
    RepetitionEmbedding,
    SequentialEmbedding,
    get_embedding,
)
