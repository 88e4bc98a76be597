from openviic_tpu_torch.decoding.beam_search import BeamSearcher, beam_search

__all__ = ["BeamSearcher", "beam_search"]
