from .public_key import GlobalPublicKey, Party, PublicKey
from .secret_key import SecretKey

__all__ = ["GlobalPublicKey", "Party", "PublicKey", "SecretKey"]
