"""The paper's own e-health models (Fig. 10): CNN for OrganAMNIST,
LSTM for MIMIC-III and ESR, as hybrid-split configs
(``repro/configs/paper_models.py``)."""
from repro_torch.common.config import ModelConfig, register_config


def paper_cnn() -> ModelConfig:
    return ModelConfig(
        name="paper-cnn", family="cnn", num_layers=2, d_model=64, num_heads=0,
        num_kv_heads=0, d_ff=128, vocab_size=11, source="paper Fig. 10",
    )


def paper_lstm() -> ModelConfig:
    return ModelConfig(
        name="paper-lstm", family="lstm", num_layers=1, d_model=64, num_heads=0,
        num_kv_heads=0, d_ff=128, vocab_size=2, source="paper Fig. 10",
    )


register_config("paper-cnn", paper_cnn, paper_cnn)
register_config("paper-lstm", paper_lstm, paper_lstm)
