"""Internet data engine (reference dataengine/): fields -> GPT topics ->
wiki/Google link harvest -> page+image download -> GPT QA -> VQA JSON.

Network stages need OPENAI_API_KEY (and GOOGLE_API_KEY/GOOGLE_SE_ID for CSE);
the assembly/cleaning stages are pure and run offline.
"""

from .engine import (
    chat_completion,
    clean_and_rename_files,
    generate_qa_pairs,
    generate_topics,
    generate_vqa,
    google_search,
    process_json_files,
    wiki_page_flow,
)
