from .transcript import TranscriptReader, TranscriptWriter, CHALLENGE_FIELD

__all__ = ["TranscriptReader", "TranscriptWriter", "CHALLENGE_FIELD"]
