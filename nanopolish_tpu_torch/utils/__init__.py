from .alphabet import Alphabet, get_alphabet_by_name, best_alphabet  # noqa: F401
