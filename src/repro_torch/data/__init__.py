from repro_torch.data.synthetic import SyntheticConfig, SyntheticStream

__all__ = ["SyntheticConfig", "SyntheticStream"]
