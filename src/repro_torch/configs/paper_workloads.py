"""The paper's own workloads (Table 3): a copy of
``repro.configs.paper_workloads``."""
from repro_torch.models.small import SmallConfig

CONFIGS = {
    "lenet-mnist": SmallConfig(name="lenet-mnist", kind="lenet", n_classes=10),
    "lenet-fashion": SmallConfig(name="lenet-fashion", kind="lenet",
                                 n_classes=10),
    "cnn-news20": SmallConfig(name="cnn-news20", kind="textcnn", n_classes=20,
                              vocab=4096, seq_len=128),
    "lstm-news20": SmallConfig(name="lstm-news20", kind="lstm", n_classes=20,
                               vocab=4096, seq_len=128),
}
