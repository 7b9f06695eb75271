from repro_torch.models.model import Model, build_model, make_batch  # noqa: F401
