from .public_key import GlobalPublicKey, Party
from .secret_key import SecretKey

__all__ = ["GlobalPublicKey", "Party", "SecretKey"]
