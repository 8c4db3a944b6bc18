"""Statistics of the port (``alink_tpu.stats``): distributions and the table
summary, numpy on the host."""

from .prob import CDF, IDF, PDF, XRandom
from .summarizer import TableSummary, summarize
