"""`dna_jellyfish`-compatible Python bindings.

Importing this package registers ``dna_jellyfish`` in ``sys.modules`` so
existing reference-user code (``import dna_jellyfish as jf``) works unchanged
against this framework:

    import jasper_tpu.bindings  # noqa: F401
    import dna_jellyfish as jf
"""

import sys

from jasper_tpu.bindings import dna_jellyfish

sys.modules.setdefault("dna_jellyfish", dna_jellyfish)
