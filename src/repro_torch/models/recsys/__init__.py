from repro_torch.models.recsys.fm import FMConfig  # noqa: F401
