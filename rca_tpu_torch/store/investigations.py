"""File-locked JSON investigation store (checkpoint/resume for sessions).

Schema parity with the reference's DBHandler (reference:
utils/db_handler.py:48-62 — ``{id, title, namespace, context, created_at,
updated_at, summary, status, conversation[], evidence{}, agent_findings{},
next_actions[], accumulated_findings[]}``; append APIs :108-233; list+sort
:281-319; ``save_hypothesis`` :321) with one fix the reference lacked:
every read-modify-write holds an exclusive ``fcntl`` lock, so concurrent
sessions cannot race on the same investigation file (reference defect:
SURVEY.md §5 race row — ``db_handler.py:353`` had no locking anywhere).
"""

from __future__ import annotations

import contextlib
import datetime
import fcntl
import json
import os
import uuid
from pathlib import Path
from typing import Any, Dict, List, Optional

ACCUMULATED_FINDINGS_CAP = 20  # reference: chatbot_interface.py:514-516


def _now() -> str:
    return datetime.datetime.now(datetime.timezone.utc).isoformat()


class InvestigationStore:
    """One JSON file per investigation under ``root`` (default
    ``RCA_LOG_DIR``, ``logs`` when unset), in the JAX package's layout:
    each package's store reads the other's files."""

    def __init__(self, root: Optional[str] = None):
        if root is None:
            from rca_tpu_torch.config import log_dir

            root = log_dir()
        self.root = Path(root)
        self.root.mkdir(parents=True, exist_ok=True)

    # -- paths / locking ----------------------------------------------------
    def _path(self, investigation_id: str) -> Path:
        safe = "".join(
            c for c in investigation_id if c.isalnum() or c in "-_"
        )
        return self.root / f"{safe}.json"

    @contextlib.contextmanager
    def _locked(self, investigation_id: str):
        """Exclusive advisory lock around one investigation's file."""
        lock_path = self._path(investigation_id).with_suffix(".lock")
        with open(lock_path, "w") as lock_file:
            fcntl.flock(lock_file, fcntl.LOCK_EX)
            try:
                yield
            finally:
                fcntl.flock(lock_file, fcntl.LOCK_UN)

    def _read(self, investigation_id: str) -> Optional[Dict[str, Any]]:
        path = self._path(investigation_id)
        if not path.exists():
            return None
        try:
            return json.loads(path.read_text())
        except (json.JSONDecodeError, OSError):
            return None

    def _write(self, inv: Dict[str, Any]) -> None:
        inv["updated_at"] = _now()
        path = self._path(inv["id"])
        tmp = path.with_suffix(".tmp")
        tmp.write_text(json.dumps(inv, indent=2, default=str))
        os.replace(tmp, path)  # atomic on POSIX

    # -- lifecycle -----------------------------------------------------------
    def create_investigation(
        self,
        title: str,
        namespace: str = "default",
        context: str = "",
        investigation_id: Optional[str] = None,
        recording_ref: Optional[str] = None,
    ) -> Dict[str, Any]:
        inv = {
            "id": investigation_id or str(uuid.uuid4()),
            "title": title,
            "namespace": namespace,
            "context": context,
            "created_at": _now(),
            "updated_at": _now(),
            "summary": "",
            "status": "active",
            "conversation": [],
            "evidence": {},
            "agent_findings": {},
            "next_actions": [],
            "accumulated_findings": [],
            # optional flight-recording path (``replay/``, REPLAY.md):
            # when set, this analysis can be re-driven deterministically
            # via `python -m rca_tpu_torch replay --investigation <id>`
            "recording_ref": recording_ref,
        }
        with self._locked(inv["id"]):
            self._write(inv)
        return inv

    def get_investigation(self, investigation_id: str) -> Optional[Dict[str, Any]]:
        return self._read(investigation_id)

    def list_investigations(self) -> List[Dict[str, Any]]:
        """Newest-first summaries (reference: db_handler.py:281-319)."""
        out = []
        for path in self.root.glob("*.json"):
            try:
                inv = json.loads(path.read_text())
            except (json.JSONDecodeError, OSError):
                continue
            if isinstance(inv, dict) and "id" in inv and "conversation" in inv:
                out.append(
                    {
                        "id": inv["id"],
                        "title": inv.get("title", ""),
                        "namespace": inv.get("namespace", ""),
                        "status": inv.get("status", ""),
                        "summary": inv.get("summary", ""),
                        "created_at": inv.get("created_at", ""),
                        "updated_at": inv.get("updated_at", ""),
                        "messages": len(inv.get("conversation", [])),
                        "replayable": bool(inv.get("recording_ref")),
                    }
                )
        out.sort(key=lambda r: r.get("updated_at", ""), reverse=True)
        return out

    def delete_investigation(self, investigation_id: str) -> bool:
        with self._locked(investigation_id):
            path = self._path(investigation_id)
            if path.exists():
                path.unlink()
                return True
        return False

    # -- append APIs ----------------------------------------------------------
    def _update(self, investigation_id: str, mutate) -> Optional[Dict[str, Any]]:
        with self._locked(investigation_id):
            inv = self._read(investigation_id)
            if inv is None:
                return None
            mutate(inv)
            self._write(inv)
            return inv

    def add_message(
        self, investigation_id: str, role: str, content: Any,
        **extra: Any,
    ) -> Optional[Dict[str, Any]]:
        def mutate(inv):
            inv["conversation"].append(
                {"role": role, "content": content, "timestamp": _now(), **extra}
            )

        return self._update(investigation_id, mutate)

    def set_next_actions(
        self, investigation_id: str, suggestions: List[dict]
    ) -> Optional[Dict[str, Any]]:
        return self._update(
            investigation_id,
            lambda inv: inv.__setitem__("next_actions", suggestions),
        )

    def add_evidence(
        self, investigation_id: str, key: str, value: Any
    ) -> Optional[Dict[str, Any]]:
        def mutate(inv):
            inv["evidence"][key] = value

        return self._update(investigation_id, mutate)

    def add_agent_findings(
        self, investigation_id: str, agent_type: str, findings: Any
    ) -> Optional[Dict[str, Any]]:
        def mutate(inv):
            inv["agent_findings"][agent_type] = findings

        return self._update(investigation_id, mutate)

    def add_accumulated_findings(
        self, investigation_id: str, findings: List[str]
    ) -> Optional[Dict[str, Any]]:
        """Append, dedup, cap at the last 20 (reference:
        chatbot_interface.py:509-516)."""

        def mutate(inv):
            acc = inv.get("accumulated_findings", [])
            for f in findings:
                if f and f not in acc:
                    acc.append(f)
            inv["accumulated_findings"] = acc[-ACCUMULATED_FINDINGS_CAP:]

        return self._update(investigation_id, mutate)

    def update_summary(
        self, investigation_id: str, summary: str
    ) -> Optional[Dict[str, Any]]:
        return self._update(
            investigation_id, lambda inv: inv.__setitem__("summary", summary)
        )

    def set_title(
        self, investigation_id: str, title: str
    ) -> Optional[Dict[str, Any]]:
        return self._update(
            investigation_id, lambda inv: inv.__setitem__("title", title)
        )

    def update_status(
        self, investigation_id: str, status: str
    ) -> Optional[Dict[str, Any]]:
        return self._update(
            investigation_id, lambda inv: inv.__setitem__("status", status)
        )

    def set_recording_ref(
        self, investigation_id: str, recording_ref: str
    ) -> Optional[Dict[str, Any]]:
        """Attach the flight recording that captured this investigation's
        served analyses — `replay --investigation <id>` resolves the
        log through this field."""
        return self._update(
            investigation_id,
            lambda inv: inv.__setitem__("recording_ref", recording_ref),
        )

    def get_recording_ref(self, investigation_id: str) -> Optional[str]:
        inv = self._read(investigation_id)
        return (inv or {}).get("recording_ref")

    def set_provenance(
        self, investigation_id: str, provenance: Dict[str, Any]
    ) -> Optional[Dict[str, Any]]:
        """Attach the LATEST causelens provenance block —
        `why <id>` renders the blame tree from this field.  Last
        write wins: an investigation's attribution tracks its most
        recent explained ranking."""
        return self._update(
            investigation_id,
            lambda inv: inv.__setitem__("provenance", provenance),
        )

    def get_provenance(
        self, investigation_id: str
    ) -> Optional[Dict[str, Any]]:
        inv = self._read(investigation_id)
        return (inv or {}).get("provenance")

    def save_hypothesis(
        self, investigation_id: str, hypothesis: Dict[str, Any]
    ) -> Optional[Dict[str, Any]]:
        def mutate(inv):
            inv.setdefault("hypotheses", []).append(
                {**hypothesis, "saved_at": _now()}
            )

        return self._update(investigation_id, mutate)

    def record_chat_turn(
        self, investigation_id: str, query: str, out: Dict[str, Any]
    ) -> None:
        """Persist one ``process_user_query`` turn — the single protocol
        for what a turn writes (user + assistant messages, next actions,
        accumulated findings), shared by the UI chat tab and the CLI's
        ``chat --investigation`` so the two cannot drift."""
        self.add_message(investigation_id, "user", query)
        self.add_message(
            investigation_id, "assistant",
            {"response_data": out.get("response_data", {}),
             "summary": out.get("summary", "")},
        )
        self.set_next_actions(investigation_id, out.get("suggestions", []))
        self.add_accumulated_findings(
            investigation_id, out.get("key_findings", [])
        )
