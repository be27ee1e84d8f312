from .bleu import Bleu  # noqa: F401
from .rouge import Rouge  # noqa: F401
from .cider import Cider  # noqa: F401
from .meteor import Meteor  # noqa: F401
