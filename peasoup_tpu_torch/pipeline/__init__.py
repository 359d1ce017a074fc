from .distill import HarmonicDistiller, AccelerationDistiller, DMDistiller
from .score import CandidateScorer
from .search import SearchConfig, PeasoupSearch, SearchResult
