from .pore_model import PoreModel, PoreModelSet, get_model  # noqa: F401
