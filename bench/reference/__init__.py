"""The plain references that decide ``correct``: float64 ``torch``, no
import of the program."""
