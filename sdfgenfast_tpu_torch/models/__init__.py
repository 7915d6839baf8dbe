from .flagship import SDFGenerator, sgd_step  # noqa: F401

__all__ = ["SDFGenerator", "sgd_step"]
