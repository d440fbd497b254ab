from repro_torch.data.synthetic import (ImageConfig, ImageStream, SyntheticConfig,
                                        SyntheticStream)

__all__ = ["SyntheticConfig", "SyntheticStream", "ImageConfig", "ImageStream"]
