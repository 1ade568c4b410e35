from repro_torch.models.model import (Model, extend_caches,
                                      prepare_decode_caches)

__all__ = ["Model", "extend_caches", "prepare_decode_caches"]
