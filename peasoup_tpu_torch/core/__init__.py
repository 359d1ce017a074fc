from .candidates import Candidate, CandidateCollection, CANDIDATE_POD_DTYPE
